"""CLI of the port:

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
    p = sub.add_parser("serve", help="online inference: dynamic-batching "
                                     "HTTP predict server with checkpoint "
                                     "hot-reload")
    p.add_argument("--preset", default="")
    p.add_argument("--config", default="")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from tpu_resnet_torch.config import load_config
    cfg = load_config(args.preset, args.config, args.overrides)
    from tpu_resnet_torch.serve.server import serve
    return serve(cfg, device=args.device)
