"""Training supervisor: stall-aware, auto-resuming long runs.

Counterpart of ``tpuflow/tools/supervise_train.py``. The port's trainer
resumes deterministically (checkpointed state, epoch-seeded data order),
so recovery can be automatic: this supervisor runs training as a child
process, watches a progress heartbeat (the mtime of the run's
``train_log.csv``), and kills and relaunches a run that stops making
progress; the relaunch resumes from the latest checkpoint.

Heartbeat, not liveness: a device client can hang rather than fail (the
process stays alive at idle CPU while no step completes), so "the
process is running" is not health; "the metrics file is advancing" is.
Crashes (nonzero exit) restart from the checkpoint the same way, within
a restart budget, so a run that is broken for good fails loudly instead
of looping. The supervisor itself is host-only; it touches no device.

Usage:
  python -m tpuflow_torch.tools.supervise_train <case> [key=value ...] \
      [--device cuda|cpu] [--stall-timeout=600] [--compile-grace=1500] \
      [--max-restarts=5] [--max-leg-seconds=0 (unbounded)]

The case, the overrides and ``--device`` pass through to
``python -m tpuflow_torch.cli.train`` unchanged; every other ``--`` flag
is the supervisor's.
"""

from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys
import time


@dataclasses.dataclass
class SupervisorConfig:
    """Knobs, all in seconds unless noted.

    ``compile_grace`` is the allowance before the FIRST heartbeat of
    each attempt (start-up, data generation, the first epoch);
    ``stall_timeout`` applies after progress has been seen.
    ``max_leg_seconds`` (0 = unbounded) additionally
    bounds each attempt's wall clock, heartbeat or not.

    ``wedge_cooldown`` is slept before relaunching after a
    *no-first-heartbeat* stall, the signature of a device client that
    hangs at initialization and may need quiet time with no client
    attached to recover. Crashes and post-progress stalls relaunch
    immediately.
    """

    stall_timeout: float = 600.0
    compile_grace: float = 1500.0
    max_restarts: int = 5
    poll_interval: float = 10.0
    max_leg_seconds: float = 0.0
    wedge_cooldown: float = 300.0


@dataclasses.dataclass
class SupervisorResult:
    exit_code: int
    restarts: int
    stalls: int
    crashes: int


def _heartbeat_mtime(path: pathlib.Path) -> float | None:
    try:
        return path.stat().st_mtime
    except OSError:
        return None


def _stop(proc: subprocess.Popen, log) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        log("child ignored SIGTERM; killing")
        proc.kill()
        proc.wait()


def supervise(
    cmd: list[str],
    heartbeat: str | pathlib.Path,
    cfg: SupervisorConfig | None = None,
    log=None,
) -> SupervisorResult:
    """Run ``cmd`` under stall supervision until it exits 0 or the
    restart budget is spent.

    Args:
      cmd: child argv (e.g. ``[sys.executable, "-m",
        "tpuflow_torch.cli.train", case, ...]``). The child must make
        progress visible by touching ``heartbeat``.
      heartbeat: file whose mtime advances while the child is healthy
        (the trainer's ``train_log.csv``).
      log: optional callable(str) for supervisor events (default:
        stderr with timestamps).

    Returns SupervisorResult; ``exit_code`` 0 means the child
    completed normally (possibly after restarts).
    """
    cfg = cfg or SupervisorConfig()
    hb = pathlib.Path(heartbeat)
    if log is None:
        def log(msg: str) -> None:
            print(
                f"[supervisor {time.strftime('%H:%M:%S')}] {msg}",
                file=sys.stderr,
                flush=True,
            )

    restarts = stalls = crashes = 0
    attempt = 0
    while True:
        attempt += 1
        start = time.monotonic()
        baseline = _heartbeat_mtime(hb)  # pre-existing file is not progress
        seen_progress = False
        log(f"attempt {attempt}: {' '.join(cmd)}")
        proc = subprocess.Popen(cmd)
        reason = None
        wedged = False
        while True:
            code = proc.poll()
            if code is not None:
                if code == 0:
                    log(f"child completed (attempt {attempt})")
                    return SupervisorResult(0, restarts, stalls, crashes)
                reason = f"crash (exit {code})"
                crashes += 1
                break
            now = time.monotonic()
            mtime = _heartbeat_mtime(hb)
            if mtime is not None and mtime != baseline:
                baseline = mtime
                seen_progress = True
                last_progress = now
            allowance = cfg.stall_timeout if seen_progress else cfg.compile_grace
            since = (now - last_progress) if seen_progress else (now - start)
            if since > allowance:
                reason = (
                    f"stall ({since:.0f}s without heartbeat on {hb.name}; "
                    f"{'post-progress' if seen_progress else 'no first heartbeat'})"
                )
                wedged = not seen_progress
                stalls += 1
                _stop(proc, log)
                break
            if cfg.max_leg_seconds and (now - start) > cfg.max_leg_seconds:
                reason = f"leg bound ({cfg.max_leg_seconds:.0f}s) reached"
                stalls += 1
                _stop(proc, log)
                break
            time.sleep(cfg.poll_interval)
        if restarts >= cfg.max_restarts:
            log(f"{reason}; restart budget spent ({cfg.max_restarts}) — giving up")
            if wedged:
                log("every attempt died without a first heartbeat — check "
                    "that the device is reachable at all")
            return SupervisorResult(1, restarts, stalls, crashes)
        restarts += 1
        log(f"{reason}; restarting from latest checkpoint "
            f"({restarts}/{cfg.max_restarts})")
        if wedged and cfg.wedge_cooldown > 0:
            log(f"no-first-heartbeat stall looks like a hung device client; "
                f"cooling down {cfg.wedge_cooldown:.0f}s before relaunch")
            time.sleep(cfg.wedge_cooldown)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sup_kwargs: dict[str, float] = {}
    train_args: list[str] = []
    args = iter(argv)
    for a in args:
        if a == "--device":
            train_args += [a, next(args, "")]
        elif a.startswith("--device="):
            train_args.append(a)
        elif a.startswith("--"):
            key, _, val = a[2:].partition("=")
            field = key.replace("-", "_")
            if field not in {f.name for f in dataclasses.fields(SupervisorConfig)}:
                raise SystemExit(f"unknown supervisor flag --{key}")
            sup_kwargs[field] = float(val)
        else:
            train_args.append(a)
    if not train_args:
        print(__doc__)
        return 2
    cfg = SupervisorConfig(**{
        k: (int(v) if k == "max_restarts" else v) for k, v in sup_kwargs.items()
    })

    from tpuflow_torch.cli import parse_args

    case_cfg, _ = parse_args(train_args)
    heartbeat = (
        pathlib.Path(case_cfg.train.checkpoint_dir)
        / case_cfg.name
        / "train_log.csv"
    )
    cmd = [sys.executable, "-m", "tpuflow_torch.cli.train", *train_args]
    result = supervise(cmd, heartbeat, cfg)
    print(
        f"supervisor done: exit={result.exit_code} restarts={result.restarts} "
        f"stalls={result.stalls} crashes={result.crashes}"
    )
    return result.exit_code


if __name__ == "__main__":
    raise SystemExit(main())
