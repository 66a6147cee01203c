"""CLI of the port:

    python -m tpu_resnet_torch train --preset cifar10 \
        model.fused_epilogue=on optim.use_pallas_xent=on \
        train.train_dir=/tmp/run
    python -m tpu_resnet_torch eval --once --preset cifar10 \
        model.fused_epilogue=on train.train_dir=/tmp/run
    python -m tpu_resnet_torch serve --preset cifar10 \
        model.fused_blocks=true model.fused_epilogue=on \
        train.train_dir=/tmp/run

Same ``--preset``/``--config``/``section.field=value`` surface as
``python -m tpu_resnet``; ``--device cpu`` runs on the CPU, otherwise the
command needs CUDA and raises without it.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        datefmt="%H:%M:%S", stream=sys.stderr)
    parser = argparse.ArgumentParser(prog="tpu_resnet_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, help_text in (
            ("train", "run the training loop (resumes from the newest "
                      "checkpoint in train.train_dir)"),
            ("eval", "checkpoint-polling evaluation (or --once)"),
            ("serve", "online inference: dynamic-batching HTTP predict "
                      "server with checkpoint hot-reload")):
        p = sub.add_parser(name, help=help_text)
        p.add_argument("--preset", default="")
        p.add_argument("--config", default="")
        p.add_argument("--device", default=None,
                       help="cuda (default) or cpu")
        if name == "eval":
            p.add_argument("--once", action="store_true",
                           help="evaluate the newest checkpoint and exit")
        p.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from tpu_resnet_torch.config import load_config
    cfg = load_config(args.preset, args.config, args.overrides)
    if args.command == "train":
        from tpu_resnet_torch.resilience.shutdown import Preempted
        from tpu_resnet_torch.train.loop import train
        try:
            train(cfg, device=args.device)
        except Preempted as e:
            logging.getLogger("tpu_resnet_torch").warning(
                "%s — exiting %d", e, cfg.resilience.preempt_exit_code)
            return cfg.resilience.preempt_exit_code
        return 0
    if args.command == "eval":
        from tpu_resnet_torch.evaluation.evaluator import evaluate
        if args.once:
            cfg.train.eval_once = True
        evaluate(cfg, device=args.device)
        return 0
    from tpu_resnet_torch.serve.server import serve
    return serve(cfg, device=args.device)
