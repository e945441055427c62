"""Profile one training window of the port on the GPU.

    python -m tpuflow_torch.tools.profile_train [--case backward-step] [--top 25]
                                                [--trace PATH]

Builds the case's model at full width from a seeded init (ActNorms
initialised from the first batch of the procedural fixture), trains one
window as a warm-up, then traces one more window with ``torch.profiler``
(CPU and CUDA activities) and prints the window's wall time, the device
time summed over every kernel, the device's idle share of the window
(the kernels run on one stream, so their times do not overlap), and the
kernels ordered by total device time, each with its share of the
window. ``--trace`` also writes the Chrome trace. Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.profiler import ProfilerActivity, profile

from tpuflow_torch.configs import load_case
from tpuflow_torch.data import load_dataset
from tpuflow_torch.device import resolve_device
from tpuflow_torch.models import TMGlow, init_lstm_state
from tpuflow_torch.train import make_optimizer, train_step


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="backward-step")
    ap.add_argument("--top", type=int, default=25, help="kernels to list")
    ap.add_argument("--trace", default="", help="write the Chrome trace here")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = load_case(args.case)
    d = cfg.data
    b = d.batch_size
    ds = load_dataset(dataclasses.replace(d, n_train_traj=b, train_steps=d.window), cfg.model)
    lf, hf = torch.from_numpy(ds.lf).to(dev), torch.from_numpy(ds.hf).to(dev)
    model = TMGlow(cfg.model, device=dev, seed=cfg.train.seed)
    model.data_init(hf[:, 0], lf[:, 0], init_lstm_state(cfg.model, b, dev))
    opt, sched = make_optimizer(model.parameters(), cfg.train.lr, cfg.train.lr_decay)

    def window():
        train_step(model, opt, sched, cfg.train.grad_clip, lf, hf,
                   init_lstm_state(cfg.model, b, dev))
        torch.cuda.synchronize()

    window()  # warm-up: cuDNN plans, allocator
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{torch.cuda.get_device_name(0)}; {args.case}, batch {b} x window {d.window}, "
          f"{cfg.model.compute_dtype} nets")
    print(f"window {wall_ms:.1f} ms under the profiler; kernels {busy_ms:.1f} ms "
          f"({sum(e.count for e in kernels)} launches); device idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% of the window")
    for e in kernels[: args.top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.2f} ms {100 * ms / wall_ms:5.1f}% {e.count:6d}x  {e.key[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


if __name__ == "__main__":
    main()
