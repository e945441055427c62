#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tpuflow_torch) on one GPU.

    python3 chip_smoke.py               # 64 members x 16 steps
    python3 chip_smoke.py --steps 100   # the 64 x 100 baseline rollout

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, drives the
port's main path (the ensemble rollout of the backward-step case at full
width, from a seeded random init) and checks that the path went through
the kernels. Every phase prints its seconds; any failed check exits
non-zero. The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

and the line before it lists each kernel's launches, parity error, time
and bound. It imports nothing of JAX or of the JAX package ``tpuflow``.
Without a GPU, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

N_MEMBERS, TAU = 64, 0.85
K2_SOURCE = "tpuflow_torch/kernels/csrc/coupling_fused.cu"
K2_REPLACES = "tpuflow/kernels/coupling_fused.py:119"
# Kernel vs plain version: y max abs error, logdet error relative to
# max(1, |logdet|). f32: both accumulate in f32, so only the summation
# order differs. bf16: same rounding of inputs and weights, but a relu
# feature near a bf16 rounding boundary can round one ulp apart; 5e-3
# leaves room for that at these shapes (worst seen on an H100: 9.2e-4)
# and still catches a fault of the bf16 instantiation alone.
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-3, 1e-3)}
ROUNDTRIP_TOL = 1e-4  # the BASELINE invertibility gate, f32
# f32 rollout stats, kernel on the card vs plain on the CPU, relative to
# max(1, max |reference|): 24 reverse couplings carry the summation-order
# differences of every conv into the sampled fields.
SLICE_TOL = 1e-4


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def coupling_macs_per_pixel(ca, cb, width, growth, layers):
    """Multiply-adds per pixel of one fused coupling (conv_in_0 + joints);
    conv_in_1 of the conditioning runs outside the kernel."""
    total0 = layers * growth + 2 * ca
    macs = 9 * cb * width
    for j in range(layers + 1):
        macs += 9 * (width if j == 0 else growth) * (total0 - j * growth)
    return macs


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_coupling(b, h, w, ca, width, growth, layers, dtype, h0c_batch, gen, dev):
    """Inputs and packed weights at lecun scale, with a random non-zero
    head (a zero head makes the coupling a constant scale)."""
    import torch

    from tpuflow_torch.kernels.coupling_fused import pack_net

    cb = ca
    total0 = layers * growth + 2 * ca

    def lecun(cout, cin):
        return (torch.randn(cout, cin, 3, 3, generator=gen) / (9 * cin) ** 0.5).to(dev)

    wjs = [lecun(total0 - j * growth, width if j == 0 else growth) for j in range(layers + 1)]
    for wj in wjs:
        wj[-2 * ca:] *= 0.1
    net = pack_net(lecun(width, cb), (0.1 * torch.randn(width, generator=gen)).to(dev), wjs,
                   (0.1 * torch.randn(total0, generator=gen)).to(dev), dtype)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev)
    h0c = None
    if h0c_batch:
        h0c = (0.5 * torch.randn(h0c_batch, h, w, width, generator=gen)).to(dev, dtype)
    return xa, xb, h0c, net


def kernel_phase(cfg, dev):
    """K2 against its plain version at the rollout's three shapes;
    returns the kernels-line entry (without launches)."""
    import torch

    from tpuflow_torch.kernels.coupling_fused import fused_coupling, fused_coupling_reference
    from tpuflow_torch.models.tmglow import scale_shapes

    gen = torch.Generator().manual_seed(1)
    width, growth, layers = cfg.coupling_width, cfg.growth_rate, cfg.coupling_layers
    b = N_MEMBERS
    worst = 0.0
    shapes = []
    c = cfg.channels
    for l, (h, w) in enumerate(scale_shapes(cfg)):
        c = 4 * c if l == 0 else 2 * c  # squeeze x4, after a split's halving
        ca = c // 2
        for dtype in (torch.float32, torch.bfloat16):
            tol_y, tol_ld = TOL[str(dtype).removeprefix("torch.")]
            for h0c_batch in (1, b, 0):
                xa, xb, h0c, net = random_coupling(b, h, w, ca, width, growth, layers,
                                                   dtype, h0c_batch, gen, dev)
                for reverse in (False, True):
                    y, ld = fused_coupling(xa, xb, h0c, net, reverse=reverse)
                    y_ref, ld_ref = fused_coupling_reference(xa, xb, h0c, net, reverse=reverse)
                    torch.cuda.synchronize()
                    err_y = (y - y_ref).abs().max().item()
                    err_ld = ((ld - ld_ref).abs() / ld_ref.abs().clamp_min(1.0)).max().item()
                    fin = bool(torch.isfinite(y).all() and torch.isfinite(ld).all())
                    print(f"  scale {l} {h}x{w} ca=cb={ca} {dtype} h0c_batch={h0c_batch} "
                          f"reverse={reverse}: y err {err_y:.3e} (tol {tol_y}), "
                          f"ld rel err {err_ld:.3e} (tol {tol_ld})", flush=True)
                    check(fin and err_y <= tol_y and err_ld <= tol_ld,
                          f"K2 vs plain at scale {l} {dtype} h0c_batch={h0c_batch} "
                          f"reverse={reverse}")
                    worst = max(worst, err_y)
        # Invertibility through the kernel: reverse(forward(x)) at f32.
        xa, xb, h0c, net = random_coupling(b, h, w, ca, width, growth, layers,
                                           torch.float32, b, gen, dev)
        y, _ = fused_coupling(xa, xb, h0c, net)
        x_rec, _ = fused_coupling(y[..., :ca].contiguous(), y[..., ca:].contiguous(), h0c,
                                  net, reverse=True)
        err_rt = (x_rec[..., :ca] - xa).abs().max().item()
        print(f"  scale {l} f32 roundtrip err {err_rt:.3e} (tol {ROUNDTRIP_TOL})", flush=True)
        check(err_rt <= ROUNDTRIP_TOL, f"K2 roundtrip at scale {l}")

        # Timing at the rollout's configuration: bf16 nets, reverse,
        # conditioning batched over the members.
        xa, xb, h0c, net = random_coupling(b, h, w, ca, width, growth, layers,
                                           torch.bfloat16, b, gen, dev)
        ms = time_ms(lambda: fused_coupling(xa, xb, h0c, net, reverse=True), 20)
        plain_ms = time_ms(lambda: fused_coupling_reference(xa, xb, h0c, net, reverse=True), 20)
        flops = 2 * b * h * w * coupling_macs_per_pixel(ca, ca, width, growth, layers)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (xa, xb, h0c, net.win0, net.b0, *net.wjs, net.bj0))
        nbytes += b * h * w * 2 * ca * 4 + b * 4  # y and ld written once
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        shapes.append(dict(scale=l, shape=[b, h, w, ca], ms=ms, plain_ms=plain_ms,
                           bound_ms=max(t_ops, t_bytes),
                           bound_by="operations" if t_ops >= t_bytes else "bytes",
                           gflop=flops / 1e9, mbytes=nbytes / 1e6))
        print(f"  scale {l} K2 {ms:.4f} ms/launch (bound {max(t_ops, t_bytes):.4f} ms, "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), plain version "
              f"{plain_ms:.4f} ms (not a yardstick)", flush=True)
    mean = lambda k: sum(s[k] for s in shapes) / len(shapes)  # noqa: E731
    return {
        "name": "fused_coupling",
        "route": "cuda",
        "source": K2_SOURCE,
        "replaces": K2_REPLACES,
        "max_abs_err": worst,
        # One launch of the main path's mix: each scale runs K couplings
        # per step, so the mix weights the three shapes equally.
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "operations" if all(s["bound_by"] == "operations" for s in shapes)
        else "bytes",
        "library_ms": None,
        "shapes": shapes,
    }


def perturb_(model, seed: int, scale: float = 0.004) -> None:
    """Seeded noise on every parameter, so the zero-init coupling heads
    and priors of the random init compute something. The scale is kept
    small: an untrained reverse coupling stack amplifies its input, and
    at full width noise of 0.01 already overflows a 64-member rollout
    to inf (measured on the CPU)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((scale * torch.randn(p.shape, generator=gen)).to(p.device))


def slice_phase(cfg, dev, steps: int):
    """The main path: 64-member stats rollout at full width, bf16."""
    import torch

    from tpuflow_torch.eval import make_ensemble_rollout
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow

    model = TMGlow(cfg, device=dev, seed=0)
    perturb_(model, 1)
    gen = torch.Generator().manual_seed(2)
    lf = torch.randn(steps, *cfg.lf_shape, cfg.channels, generator=gen).to(dev)
    rollout = make_ensemble_rollout(model, N_MEMBERS, TAU, "stats")
    rollout(lf[:2], torch.Generator(dev).manual_seed(3))  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    coupling_fused.launches = 0
    t0 = time.perf_counter()
    out = rollout(lf, torch.Generator(dev).manual_seed(4))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = coupling_fused.launches

    per_step = cfg.n_scales * cfg.n_flow_steps
    shape = (steps, *cfg.hf_shape, cfg.channels)
    print(f"  rollout {N_MEMBERS} members x {steps} steps: {elapsed:.3f} s, "
          f"{steps / elapsed:.3f} steps/s, K2 launches {launches} "
          f"(expected {per_step} x {steps})", flush=True)
    check(launches == per_step * steps, "K2 launch count of the rollout")
    for k in ("mean", "var"):
        check(tuple(out[k].shape) == shape, f"{k} shape {tuple(out[k].shape)}")
        check(bool(torch.isfinite(out[k]).all()), f"{k} finite")
    check(bool((out["var"] >= 0).all()), "var >= 0")
    print(f"  mean |mean| {out['mean'].abs().mean().item():.4f}, "
          f"mean var {out['var'].mean().item():.4f}", flush=True)

    # K2's share of the path: CUDA events around every K2 call in a
    # second run of the same rollout (the counted run above stays
    # uninstrumented). A pair of events also holds any time the stream
    # waits for the host inside the call, so this bounds K2's device
    # time from above.
    from tpuflow_torch.flows import coupling

    k2, events = coupling.fused_coupling, []

    def timed_k2(xa, xb, h0c, net, reverse=False):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = k2(xa, xb, h0c, net, reverse=reverse)
        end.record()
        events.append((xa.shape[1], start, end))
        return res

    coupling.fused_coupling = timed_k2
    try:
        t0 = time.perf_counter()
        rollout(lf, torch.Generator(dev).manual_seed(4))
        torch.cuda.synchronize()
        elapsed_timed = time.perf_counter() - t0
    finally:
        coupling.fused_coupling = k2
    check(len(events) == per_step * steps, "K2 calls of the instrumented run")
    by_h: dict[int, list[float]] = {}
    for h, start, end in events:
        by_h.setdefault(h, []).append(start.elapsed_time(end))
    per_launch = [sum(by_h[h]) / len(by_h[h]) for h in sorted(by_h, reverse=True)]
    k2_ms = sum(sum(v) for v in by_h.values())
    share = k2_ms / (elapsed_timed * 1e3)
    print(f"  instrumented rerun: {steps / elapsed_timed:.3f} steps/s; K2 in the rollout "
          f"{' / '.join(f'{t:.4f}' for t in per_launch)} ms per launch by scale, "
          f"{k2_ms / steps:.3f} ms per step, {100 * share:.1f}% of the step", flush=True)
    return launches, steps / elapsed, per_launch, share


def reference_phase(cfg, dev):
    """The rollout at f32 on a small input: kernel on the card against
    the plain version on the CPU, same weights and draws."""
    import dataclasses

    import torch

    from tpuflow_torch.eval import make_ensemble_rollout
    from tpuflow_torch.models import TMGlow

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = TMGlow(cfg32, device="cpu", seed=0)
    perturb_(cpu, 1)
    gpu = TMGlow(cfg32, device=dev, seed=0)
    gpu.load_state_dict(cpu.state_dict())
    n, steps = 2, 2
    gen = torch.Generator().manual_seed(5)
    lf = torch.randn(steps, *cfg.lf_shape, cfg.channels, generator=gen)
    feats = cpu.encode_lf(lf[:1])
    eps = []
    for _ in range(steps):
        row, c = [], cfg.channels
        for l, f in enumerate(feats):
            h, w = f.shape[1:3]
            c *= 4
            ch = c // 2 if l < cfg.n_scales - 1 else c
            row.append(torch.randn(n, h, w, ch, generator=gen))
            c = ch
        eps.append(row)
    want = make_ensemble_rollout(cpu, n, TAU)(lf, eps=eps)
    got = make_ensemble_rollout(gpu, n, TAU)(
        lf.to(dev), eps=[[e.to(dev) for e in row] for row in eps])
    for k in ("mean", "var"):
        err = (got[k].cpu() - want[k]).abs().max().item()
        scale = want[k].abs().max().item()
        print(f"  f32 rollout {k}: max abs err {err:.3e} (tol {SLICE_TOL} x max(1, max |ref|)), "
              f"max |ref| {scale:.3f}", flush=True)
        check(bool(torch.isfinite(got[k]).all()) and err <= SLICE_TOL * max(1.0, scale),
              f"f32 rollout {k} vs plain reference")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16,
                    help="rollout steps of the main-path run (default 16)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    try:
        from tpuflow_torch.configs import load_case
        from tpuflow_torch.device import resolve_device
        from tpuflow_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})", file=sys.stderr)
        return 1

    with phase("device"):
        dev = resolve_device("cuda")
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}; device {name}")
        print(smi, flush=True)

    with phase("build"):
        _build.load("coupling_fused")

    cfg = load_case("backward-step").model
    with phase("kernel vs plain"):
        k2 = kernel_phase(cfg, dev)

    with phase("slice"):
        launches, steps_per_s, rollout_ms, share = slice_phase(cfg, dev, args.steps)
        for s, ms in zip(k2["shapes"], rollout_ms):
            s["rollout_ms"] = ms
        k2["share_of_step"] = share
        print(f"  K2 bound per rollout step "
              f"{sum(s['bound_ms'] for s in k2['shapes']) * cfg.n_flow_steps:.4f} ms",
              flush=True)

    with phase("reference"):
        reference_phase(cfg, dev)

    k2["launches"] = launches
    print(smi)
    print(json.dumps({"kernels": [k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
