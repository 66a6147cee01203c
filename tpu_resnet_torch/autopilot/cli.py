"""``python -m tpu_resnet_torch autopilot``: the control process (the
reference's ``tpu_resnet/autopilot/cli.py``).

Starts the controller's loop and its own telemetry server (the
``AUTOPILOT_GAUGES`` registry on ``autopilot.port``, announced in
``<dir>/autopilot.json``), blocks on the flag-only
``ShutdownCoordinator``, and tears down in order: the server closed, the
loop joined, the spawned replicas drained and reaped, the writers
closed. Host code: no torch, no device.
"""

from __future__ import annotations

import logging
from typing import Optional

from tpu_resnet_torch.autopilot.controller import (AUTOPILOT_DISCOVERY,
                                                   AutopilotController)
from tpu_resnet_torch.config import RunConfig
from tpu_resnet_torch.obs.server import TelemetryServer
from tpu_resnet_torch.serve.discovery import read_port, write_record

log = logging.getLogger("tpu_resnet_torch")


def write_autopilot_discovery(directory: str, port: int,
                              run_id: Optional[str] = None) -> None:
    """Atomic ``<dir>/autopilot.json``, the fleetmon.json of the
    controller (a scraper dials from here)."""
    write_record(directory, AUTOPILOT_DISCOVERY, port,
                 extra={"run_id": run_id, "kind": "autopilot"})


def read_autopilot_port(directory: str) -> Optional[int]:
    return read_port(directory, AUTOPILOT_DISCOVERY)


def autopilot(cfg: RunConfig) -> int:
    """CLI entry: start the control loop + telemetry, announce
    autopilot.json, block until SIGTERM/SIGINT, exit 0."""
    from tpu_resnet_torch.resilience import exitcodes
    from tpu_resnet_torch.resilience.shutdown import ShutdownCoordinator

    directory = cfg.autopilot.discover_dir or cfg.train.train_dir
    if not directory:
        log.error("autopilot: need autopilot.discover_dir=<dir with "
                  "route.json/serve*.json> or train.train_dir")
        return exitcodes.USAGE_ERROR
    coordinator = ShutdownCoordinator(
        enabled=cfg.resilience.graceful_shutdown,
        action_desc="stopping the autopilot loop (spawned replicas "
                    "terminated via their drain contract), then "
                    "exiting 0")
    ctl = AutopilotController(cfg)
    server = None
    with coordinator:
        ctl.start()
        if cfg.autopilot.port >= 0:
            server = TelemetryServer(ctl.registry, cfg.autopilot.port,
                                     cfg.autopilot.host)
            write_autopilot_discovery(directory, server.port,
                                      run_id=ctl.run_id)
            log.info(
                "autopilot: ready on :%d — steering %s every %.1fs "
                "(replicas %d..%d%s; /metrics; /healthz)", server.port,
                directory, cfg.autopilot.poll_interval_secs,
                cfg.autopilot.min_replicas, cfg.autopilot.max_replicas,
                "; OBSERVE-ONLY" if ctl.actuator.observe_only else "")
        try:
            while not coordinator.event.wait(0.5):
                pass
            log.info("autopilot: shutdown requested (%s)",
                     coordinator.signum)
        except KeyboardInterrupt:
            log.warning("autopilot: immediate abort requested")
        finally:
            if server is not None:
                server.close()
            ctl.close()
    log.info("autopilot: exited cleanly")
    return 0
