"""CLI of the port:

    python -m tpu_resnet_torch train --preset cifar10 \
        model.fused_epilogue=on optim.use_pallas_xent=on \
        train.train_dir=/tmp/run
    python -m tpu_resnet_torch eval --once --preset cifar10 \
        model.fused_epilogue=on train.train_dir=/tmp/run
    python -m tpu_resnet_torch serve --preset cifar10 \
        model.fused_blocks=true model.fused_epilogue=on \
        train.train_dir=/tmp/run            # serve.quantize=int8: int8 arm
    python -m tpu_resnet_torch export --preset cifar10 \
        model.fused_blocks=true model.fused_epilogue=on \
        train.train_dir=/tmp/run --out /tmp/run/export [--batch-size 0]
    python -m tpu_resnet_torch serve --preset cifar10 \
        serve.backend=export serve.export_dir=/tmp/run/export \
        train.train_dir=/tmp/run
    python -m tpu_resnet_torch predict --preset cifar10 \
        --export-dir /tmp/run/export --out /tmp/predict
    python -m tpu_resnet_torch info --preset imagenet [--layers]
    python -m tpu_resnet_torch inspect --dir /tmp/run [--step N] [--peek P]
    python -m tpu_resnet_torch plot --dir /tmp/run [--out F] [--csv F]
    python -m tpu_resnet_torch trace-export --dir /tmp/run [--device-trace]
    python -m tpu_resnet_torch doctor [--data-dir D --dataset N] \
        [--train-dir D] [--data-bench] [--fault-drill] [--fleet-probe] \
        [--fleetmon-probe]

The serving fleet: replicas announce themselves in one directory
(``serve.replica_name=r0`` writes ``serve-r0.json``), the router and the
fleet monitor find them there:

    python -m tpu_resnet_torch serve --preset imagenet \
        model.fused_blocks=true model.fused_epilogue=on \
        train.train_dir=/tmp/run serve.replica_name=r0 serve.port=0
    python -m tpu_resnet_torch route route.discover_dir=/tmp/run \
        [--watch-discovery]
    python -m tpu_resnet_torch route --drain r0 route.discover_dir=/tmp/run
    python -m tpu_resnet_torch fleetmon fleet.discover_dir=/tmp/run \
        fleet.slo_ms=50

Same ``--preset``/``--config``/``section.field=value`` surface as
``python -m tpu_resnet``; ``--device cpu`` runs ``train``, ``eval``,
``serve``, ``export`` and ``predict`` on the CPU, otherwise they need CUDA
and raise without it.
``info`` (the model on the ``meta`` device), ``inspect``, ``plot``,
``trace-export``, ``route`` and ``fleetmon`` touch no device (the last
two import no torch: host code in front of the replicas); ``doctor``
probes the card and fails its checks where there is none.

Data parallelism: ``train`` with ``mesh.data=N`` > 1 (or ``-1`` with more
than one visible card) starts one process per card with
``torch.multiprocessing`` (``spawn``), joined in an NCCL process group
(``parallel/multihost.py``); with ``--device cpu`` it starts N gloo ranks:

    python -m tpu_resnet_torch train --device cpu --preset smoke \
        mesh.data=2 model.sync_bn=false train.train_dir=/tmp/dp

A multi-node run sets the reference's launcher variables on every node
(``TPU_COORDINATOR_ADDRESS=host:port``, ``TPU_NUM_PROCESSES``,
``TPU_PROCESS_ID``); each node then starts a rank per local card. A rank
that fails ends the others and the run exits nonzero; a SIGTERM to the
launcher reaches every rank, which stop together, save and exit 42, as one
process does.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import socket
import sys

# The commands that take a run config, and those of them that run on a
# device.
_RUN_COMMANDS = ("train", "eval", "export", "predict", "serve", "info",
                 "route", "fleetmon")
_DEVICE_COMMANDS = ("train", "eval", "export", "predict", "serve")


def _log_setup(prefix: str = "") -> None:
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s {prefix}%(name)s %(levelname)s: %(message)s",
        datefmt="%H:%M:%S", stream=sys.stderr)


def _train_one(cfg, device) -> int:
    from tpu_resnet_torch.resilience.shutdown import Preempted
    from tpu_resnet_torch.train.loop import train
    try:
        train(cfg, device=device)
    except Preempted as e:
        logging.getLogger("tpu_resnet_torch").warning(
            "%s — exiting %d", e, cfg.resilience.preempt_exit_code)
        return cfg.resilience.preempt_exit_code
    return 0


def _rank_main(local_rank: int, cfg, device_type: str, coordinator: str,
               num_processes: int, process_id: int, local_world: int) -> None:
    """One spawned rank: join the group, train on its card, leave."""
    _log_setup(f"[rank {process_id * local_world + local_rank}] ")
    import torch

    from tpu_resnet_torch.parallel import multihost
    try:
        multihost.initialize(coordinator, num_processes, process_id,
                             local_rank=local_rank, local_world=local_world,
                             device_type=device_type)
        if device_type == "cpu":  # the node's cores, split over its ranks
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // local_world))
        device = (f"cuda:{torch.cuda.current_device()}"
                  if device_type == "cuda" else "cpu")
        code = _train_one(cfg, device)
    finally:
        multihost.shutdown()
    if code:
        sys.exit(code)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ranks_to_start(cfg, device_type: str, num_processes: int = 1) -> int:
    """This node's rank count: ``mesh.data`` over the processes, fitted to
    the visible cards on CUDA (``parallel.fit_mesh``: an explicit size
    that does not fit is downsized, ``-1`` takes every card); on the CPU
    ``mesh.data`` ranks (``-1``: one)."""
    from tpu_resnet_torch.parallel import fit_mesh
    if device_type == "cpu":
        return max(1, cfg.mesh.data) // num_processes
    import torch
    cards = torch.cuda.device_count()
    if cards == 0:
        return 1  # train() raises the no-CUDA error
    data, _, _ = fit_mesh(cfg.mesh, num_processes * cards)
    return max(1, data // num_processes)


def train_command(cfg, device=None) -> int:
    """``train``: in this process for one rank and no cluster, else one
    spawned process per rank of this node."""
    import torch.multiprocessing as mp

    device_type = "cpu" if str(device).startswith("cpu") else "cuda"
    coordinator = os.environ.get("TPU_COORDINATOR_ADDRESS")
    num_processes = int(os.environ.get("TPU_NUM_PROCESSES", "1"))
    process_id = int(os.environ.get("TPU_PROCESS_ID", "0"))
    n = ranks_to_start(cfg, device_type, num_processes)
    if n == 1 and coordinator is None and num_processes == 1:
        return _train_one(cfg, device)
    # A layout the ranks would refuse is refused before any spawn.
    from tpu_resnet_torch.resilience import elastic
    from tpu_resnet_torch.train.step import check_step_config
    check_step_config(cfg, elastic.resolve(cfg, n * num_processes).mesh.data)
    coordinator = coordinator or f"127.0.0.1:{_free_port()}"
    ctx = mp.start_processes(
        _rank_main, args=(cfg, device_type, coordinator, num_processes,
                          process_id, n),
        nprocs=n, join=False, start_method="spawn")

    def forward(signum, frame):
        """A SIGTERM to the launcher is every rank's graceful stop."""
        for proc in ctx.processes:
            try:
                os.kill(proc.pid, signum)
            except ProcessLookupError:
                pass

    previous = signal.signal(signal.SIGTERM, forward)
    try:
        while not ctx.join():
            pass
    except mp.ProcessExitedException as e:
        # join() ended every other rank.
        code = e.exit_code if e.exit_code and e.exit_code > 0 else 1
        logging.getLogger("tpu_resnet_torch").error("%s", e)
        return code
    except mp.ProcessRaisedException as e:
        logging.getLogger("tpu_resnet_torch").error("%s", e)
        return 1
    finally:
        signal.signal(signal.SIGTERM, previous)
    return 0


def main(argv=None) -> int:
    _log_setup()
    raw = sys.argv[1:] if argv is None else list(argv)
    if raw[:1] == ["trace-export"]:
        # Delegated whole, as the reference does: the exporter owns its
        # flags and reads files only.
        from tpu_resnet_torch.obs.trace import main as trace_main
        return trace_main(raw[1:])
    parser = argparse.ArgumentParser(prog="tpu_resnet_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, help_text in (
            ("train", "run the training loop (resumes from the newest "
                      "checkpoint in train.train_dir)"),
            ("eval", "checkpoint-polling evaluation (or --once)"),
            ("export", "freeze a checkpoint into a serialized inference "
                       "artifact"),
            ("predict", "run a frozen artifact over the eval split"),
            ("serve", "online inference: dynamic-batching HTTP predict "
                      "server with checkpoint hot-reload"),
            ("route", "serving-fleet front router: spread /predict over N "
                      "serve replicas with health-probed failover, "
                      "SLO-aware load shedding and rolling drains"),
            ("fleetmon", "fleet telemetry aggregator: discover every "
                         "serve/route/train endpoint in a dir, scrape all "
                         "/metrics on an interval into an on-disk "
                         "timeseries, merge per-replica latency histograms "
                         "into true fleet p50/p95/p99, page on SLO "
                         "error-budget burn"),
            ("info", "print resolved config, param count and forward "
                     "FLOPs"),
            ("inspect", "list the tensors of a checkpoint"),
            ("plot", "render precision/loss/throughput curves from "
                     "metrics.jsonl"),
            ("trace-export", "merge a run's spans/metrics/eval/serve "
                             "events (and a profiler capture) into one "
                             "Chrome-trace JSON"),
            ("doctor", "environment triage: versions, CUDA probe, kernel "
                       "build and launch, dataset layout, run "
                       "telemetry")):
        p = sub.add_parser(name, help=help_text)
        if name in _RUN_COMMANDS:
            p.add_argument("--preset", default="")
            p.add_argument("--config", default="")
            if name in _DEVICE_COMMANDS:
                p.add_argument("--device", default=None,
                               help="cuda (default) or cpu")
        if name == "eval":
            p.add_argument("--once", action="store_true",
                           help="evaluate the newest checkpoint and exit")
        if name == "route":
            p.add_argument("--drain", default="",
                           help="rolling operations: ask a RUNNING "
                                "router to drain replica NAME (exclude "
                                "from rotation, wait out in-flight, "
                                "SIGTERM per the drain contract) and "
                                "exit — instead of starting a router")
            p.add_argument("--router-url", default="",
                           help="with --drain: the running router's "
                                "base url (default: discovered from "
                                "route.json in route.discover_dir)")
            p.add_argument("--watch-discovery", action="store_true",
                           help="merit-gated dynamic membership: a "
                                "replica whose discovery record appears "
                                "after boot enters rotation only after "
                                "its first successful health probe "
                                "(shorthand for "
                                "route.watch_discovery=true)")
        if name == "info":
            p.add_argument("--layers", action="store_true",
                           help="per-parameter table (tfprof-style dump)")
        if name == "export":
            p.add_argument("--out", required=True,
                           help="output directory for the frozen artifact")
            p.add_argument("--step", type=int, default=None)
            p.add_argument("--batch-size", type=int, default=0,
                           help="0 = dynamic batch dimension")
        if name == "predict":
            p.add_argument("--export-dir", required=True)
            p.add_argument("--out", default="/tmp/tpu_resnet_predict")
            p.add_argument("--num-examples", type=int, default=256)
            p.add_argument("--label-file", default="",
                           help="imagenet idx→name map file")
        if name in _RUN_COMMANDS:
            p.add_argument("overrides", nargs="*")
        if name == "inspect":
            p.add_argument("--dir", required=True, help="train/ckpt dir")
            p.add_argument("--step", type=int, default=None)
            p.add_argument("--peek", default=None,
                           help="print stats+head of one tensor by path")
        if name == "plot":
            p.add_argument("--dir", required=True, help="train dir")
            p.add_argument("--out", default=None, help="output PNG path")
            p.add_argument("--csv", default=None,
                           help="also export merged series as CSV")
        if name == "doctor":
            p.add_argument("--dataset", default="",
                           help="with --data-dir: layout to validate")
            p.add_argument("--data-dir", default="")
            p.add_argument("--train-dir", default="",
                           help="running run's dir: check its telemetry "
                                "server answers /metrics + /healthz")
            p.add_argument("--probe-timeout", type=int, default=60)
            p.add_argument("--data-bench", action="store_true",
                           help="~10 s synthetic-JPEG decode throughput "
                                "probe on the card: images/sec at 1 vs N "
                                "decode threads + implied max steps/sec")
            p.add_argument("--fault-drill", action="store_true",
                           help="live SIGTERM+resume drill of a small "
                                "ResNet on the card: preemption exit "
                                "code, checkpoint at the stop step, "
                                "exact-step resume")
            p.add_argument("--fleet-probe", action="store_true",
                           help="serving-fleet resilience drill on the "
                                "card: 2 serve replicas behind the "
                                "router, one SIGKILLed under loadgen "
                                "traffic (zero client failures, circuit "
                                "opens), hot-reload on the survivor, "
                                "rolling admin drain, router exit 0, "
                                "merged trace with router+replica lanes")
            p.add_argument("--fleetmon-probe", action="store_true",
                           help="fleet-observability drill on the card: "
                                "2 replicas + router + fleetmon, one "
                                "replica fault-slowed -> fleet p99 above "
                                "the healthy replica's own, burn alert "
                                "fires, slow traces attribute to the "
                                "slowed replica")
    args = parser.parse_args(raw)

    if args.command == "doctor":
        from tpu_resnet_torch.tools.doctor import run_doctor
        if args.dataset and not args.data_dir:
            parser.error("doctor --dataset requires --data-dir")
        summary = run_doctor(dataset=args.dataset, data_dir=args.data_dir,
                             train_dir=args.train_dir,
                             probe_timeout=args.probe_timeout,
                             fault_drill=args.fault_drill,
                             data_bench=args.data_bench,
                             fleet_probe=args.fleet_probe,
                             fleetmon_probe=args.fleetmon_probe)
        return 0 if summary["ok"] else 1
    if args.command == "inspect":
        from tpu_resnet_torch.tools.inspect_ckpt import main as inspect_main
        inspect_main(args.dir, step=args.step, peek=args.peek)
        return 0
    if args.command == "plot":
        from tpu_resnet_torch.tools.plot_metrics import plot
        try:
            print(f"wrote {plot(args.dir, out=args.out, csv_out=args.csv)}")
        except ImportError as e:
            print(f"plot: no PNG ({e})" + (f"; wrote {args.csv}"
                                           if args.csv else ""))
            return 1
        return 0

    from tpu_resnet_torch.config import load_config
    cfg = load_config(args.preset, args.config, args.overrides)
    if args.command == "route":
        # Host code in front of the replicas: no torch, no device.
        from tpu_resnet_torch.serve.router import (read_route_port,
                                                   request_drain, route)
        if args.drain:
            url = args.router_url
            if not url:
                port = read_route_port(cfg.route.discover_dir
                                       or cfg.train.train_dir)
                if port is None:
                    parser.error("route --drain: no route.json found; "
                                 "pass --router-url or "
                                 "route.discover_dir=<dir>")
                url = f"http://127.0.0.1:{port}"
            result = request_drain(url, args.drain)
            print(json.dumps(result))
            return 0 if result.get("ok") else 1
        if args.watch_discovery:
            cfg.route.watch_discovery = True
        return route(cfg)
    if args.command == "fleetmon":
        from tpu_resnet_torch.obs.fleet import fleetmon
        return fleetmon(cfg)
    if args.command == "info":
        from tpu_resnet_torch.tools.analysis import print_model_info
        print_model_info(cfg, layers=args.layers)
        return 0
    if args.command == "train":
        return train_command(cfg, args.device)
    if args.command == "eval":
        from tpu_resnet_torch.evaluation.evaluator import evaluate
        if args.once:
            cfg.train.eval_once = True
        evaluate(cfg, device=args.device)
        return 0
    if args.command == "export":
        from tpu_resnet_torch.export import export_from_checkpoint
        out = export_from_checkpoint(cfg, args.out, step=args.step,
                                     batch_size=args.batch_size,
                                     device=args.device)
        print(f"exported inference artifact to {out}")
        return 0
    if args.command == "predict":
        from tpu_resnet_torch.tools.predict import predict_from_export
        predict_from_export(cfg, args.export_dir, args.out,
                            num_examples=args.num_examples,
                            label_file=args.label_file, device=args.device)
        return 0
    from tpu_resnet_torch.serve.server import serve
    return serve(cfg, device=args.device)
