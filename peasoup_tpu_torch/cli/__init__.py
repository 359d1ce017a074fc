"""The port's command-line entry points, and the observability wiring they
share (the JAX package's cli/__init__.py): every CLI takes the same flags,
``--log-level`` (stderr library logging), ``--metrics-json`` (the
telemetry.json run manifest), ``--capture-device-trace`` (per-scope device
time from torch.profiler folded into the manifest), ``--status-json`` /
``--heartbeat-interval`` (the live status.json heartbeat and stall
watchdog) and ``--no-flight-recorder`` (the crash flight recorder is on by
default), and ``--version``, resolved here so their names and meanings
cannot drift between tools."""

from __future__ import annotations

import argparse
import contextlib
import os


class _VersionAction(argparse.Action):
    """--version for every CLI: the port's version, torch's, and the
    device a run takes by default. Imports stay lazy so ``--help`` pays
    for no device initialisation."""

    def __call__(self, parser, namespace, values, option_string=None):
        import torch

        from .. import __version__

        if torch.cuda.is_available():
            device = f"cuda ({torch.cuda.get_device_name(0)})"
        else:
            device = "unavailable (no CUDA device; pass --device cpu)"
        print(f"peasoup_tpu_torch {__version__} (torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, device {device})")
        parser.exit(0)


def add_version_arg(p) -> None:
    """--version: the port's version, torch's, and the device."""
    p.add_argument("--version", action=_VersionAction, nargs=0,
                   help="print the package's version, torch's, and the device, then exit")


def add_log_level_arg(p) -> None:
    """--log-level, the library log threshold of every CLI."""
    p.add_argument(
        "--log-level", dest="log_level", default=None,
        choices=["debug", "info", "warning", "error"],
        help="library log threshold (messages go to stderr; default warning, or "
        "info with -v; PEASOUP_LOG_LEVEL also works)",
    )


def add_observability_args(p) -> None:
    """The JAX CLIs' observability flags, flag by flag, and --version."""
    add_version_arg(p)
    g = p.add_argument_group("observability")
    add_log_level_arg(g)
    g.add_argument(
        "--metrics-json", dest="metrics_json", default=None,
        help="path for the telemetry.json run manifest (peasoup and spsearch "
        "default to <outdir>/telemetry.json; the other tools write one only "
        "when this flag is given)",
    )
    g.add_argument(
        "--capture-device-trace", dest="capture_device_trace", action="store_true",
        help="profile the run with torch.profiler and fold per-scope device time "
        "and the kernels' own times into the manifest (opt-in: tracing costs "
        "wall time and memory)",
    )
    g.add_argument(
        "--status-json", dest="status_json", default=None,
        help="write a live status.json heartbeat here (current stage, "
        "progress/rate/ETA, memory gauges, event tail), atomically rewritten "
        "every --heartbeat-interval seconds",
    )
    g.add_argument(
        "--heartbeat-interval", dest="heartbeat_interval", type=float, default=5.0,
        help="seconds between status.json heartbeats (default 5); the stall "
        "watchdog fires after PEASOUP_STALL_TIMEOUT (default 300) seconds "
        "without progress",
    )
    g.add_argument(
        "--no-flight-recorder", dest="no_flight_recorder", action="store_true",
        help="disable the crash flight recorder (on by default: SIGTERM/SIGINT/"
        "fatal exceptions dump flight.json plus a partial telemetry manifest "
        "marked aborted)",
    )


def init_observability(args):
    """Configure the library logger from parsed flags and return the run's
    RunTelemetry (activate it around the pipeline call)."""
    from ..obs import RunTelemetry, configure_logging

    configure_logging(args.log_level, getattr(args, "verbose", False))
    return RunTelemetry(capture_device_trace=getattr(args, "capture_device_trace", False))


@contextlib.contextmanager
def live_observability(tel, args, workdir, manifest_path=None):
    """Arm the live layer around a pipeline call: install the crash flight
    recorder (unless ``--no-flight-recorder``) and start the status.json
    heartbeat (with ``--status-json``).

    The flight recorder is installed before the heartbeat's first
    snapshot, so a watcher that waits for status.json can rely on abort
    forensics being armed. A propagating exception dumps flight.json and
    the partial manifest before the stack unwinds; a clean exit writes
    neither (the heartbeat's final ``"done": true`` snapshot is the only
    trace left behind)."""
    from ..obs.flight import FlightRecorder
    from ..obs.heartbeat import Heartbeat

    recorder = None
    heartbeat = None
    workdir = workdir or "."
    if not getattr(args, "no_flight_recorder", False):
        recorder = FlightRecorder(
            tel, os.path.join(workdir, "flight.json"), manifest_path=manifest_path,
        ).install()
    if getattr(args, "status_json", None):
        stall = float(os.environ.get("PEASOUP_STALL_TIMEOUT", 300.0))
        heartbeat = Heartbeat(
            tel, args.status_json, interval=getattr(args, "heartbeat_interval", 5.0),
            stall_timeout=stall,
        ).start()
    try:
        yield
    except BaseException as exc:
        if recorder is not None and not isinstance(exc, GeneratorExit):
            import traceback

            recorder.dump(
                f"exception:{type(exc).__name__}",
                exception="".join(
                    traceback.format_exception_only(type(exc), exc)).strip(),
            )
        raise
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        if recorder is not None:
            recorder.close()


def write_shard(tel, manifest_path: str) -> None:
    """In a run of several processes, write this process's manifest shard
    beside ``manifest_path`` as ``<stem>.procN<ext>`` (its stage timers are
    its own; the JAX package's cli/peasoup.py:200-205). Rank 0 writes
    ``manifest_path`` itself once its outputs are written."""
    from ..parallel import multihost

    if multihost.process_count() > 1:
        base, ext = os.path.splitext(manifest_path)
        tel.write(f"{base}.proc{multihost.process_index()}{ext or '.json'}")
