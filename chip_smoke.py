#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tpuflow_torch) on one GPU.

    python3 chip_smoke.py               # 64 members x 16 steps
    python3 chip_smoke.py --steps 100   # the 64 x 100 baseline rollout

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per source, all started together), holds each kernel against
its plain PyTorch version on the card, and drives the port's paths,
each with the launch counts set to 0 just before it and read just after:

  * the ensemble rollout of the backward-step case at full width, from a
    seeded random init, through the fused coupling K2 (phase "slice");
  * training at full width through the CLI, ``python -m
    tpuflow_torch.cli.train``, in-process on a small fixture: every
    coupling forward launches K2, its backward differentiates the plain
    version; then a resume from the saved checkpoint (phase "train");
  * the coupling-apply entry point ``kernels.coupling_apply``, forward,
    reverse and gradient, through K1 (phase "K1 vs plain").

Every phase prints its seconds; any failed check exits non-zero. The
last line of standard output is

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
import math
import pathlib
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

N_MEMBERS, TAU = 64, 0.85
PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
K1_SOURCE = "tpuflow_torch/kernels/csrc/coupling_apply.cu"
K1_REPLACES = "tpuflow/kernels/coupling_pallas.py:52"
# K1 at the shapes of the three Glow scales' couplings with 64 members
# (bench.py:377 times the first).
K1_SHAPES = [(64, 32, 64, 6), (64, 16, 32, 12), (64, 8, 16, 24)]
# Operations per element of K1: shift, min, abs, negate, exp, log1p,
# subtract, exp, add, multiply, and the logdet add.
K1_OPS_PER_ELEMENT = 11
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
# K1 vs plain, the JAX package's tolerances (tests/test_kernels.py:38-39,
# 47, 67): y within 1e-6 + 1e-6 |y|, logdet 1e-5 relative to max(1, |ld|),
# roundtrip 1e-5, gradients within 1e-5 + 1e-5 |g|. Both sides compute
# the same float32 expressions; only libm and the summation order differ.
K1_TOL_Y, K1_TOL_LD, K1_TOL_RT, K1_TOL_GRAD = 1e-6, 1e-5, 1e-5, 1e-5
# Training, one f32 window with the kernel forward against the same
# window with the plain forward: loss 1e-5 relative, each gradient
# 1e-3 x max(1, max |g|). Both backwards run the same plain code; they
# differ by the forwards' summation order (~5e-7 per coupling output),
# carried through 2 steps x 24 couplings and, for a bias, summed over
# the 4096 pixels of a batch-2 scale-0 plane with cancellation (worst
# seen on an H100: 1.3e-4, a joint_0 bias). A fault in the kernel moves
# gradients by O(1) of their size.
TRAIN_TOL_LOSS, TRAIN_TOL_GRAD = 1e-5, 1e-3
# The training phase's fixture: 8 trajectories of 16 steps, batch 8,
# window 8, 2 epochs: 2 windows per epoch, 4 optimizer steps.
TRAIN_ARGS = ["data.n_train_traj=8", "data.train_steps=16", "data.batch_size=8",
              "data.window=8", "train.log_every=1"]
TRAIN_EPOCHS = 2
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


def time_graph_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed between CUDA events, so the host's cost per call (the
    Python wrapper, allocation, the launch itself) is not in the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def k1_phase(dev):
    """K1 against its plain version at the three scales' shapes: forward,
    reverse, determinism, roundtrip, gradients and time per launch;
    returns the kernels-line entry (without launches)."""
    import torch

    from tpuflow_torch.kernels.coupling_apply import coupling_apply, coupling_apply_reference

    gen = torch.Generator().manual_seed(7)
    shapes, worst = [], 0.0
    for shape in K1_SHAPES:
        x, raw, t = ((scale * torch.randn(shape, generator=gen)).to(dev)
                     for scale in (1.0, 0.5, 1.0))
        for reverse in (False, True):
            y, ld = coupling_apply(x, raw, t, reverse=reverse)
            y2, ld2 = coupling_apply(x, raw, t, reverse=reverse)
            y_ref, ld_ref = coupling_apply_reference(x, raw, t, reverse=reverse)
            torch.cuda.synchronize()
            err_y = (y - y_ref).abs().max().item()
            ok_y = bool(((y - y_ref).abs() <= K1_TOL_Y + K1_TOL_Y * y_ref.abs()).all())
            err_ld = ((ld - ld_ref).abs() / ld_ref.abs().clamp_min(1.0)).max().item()
            print(f"  {shape} reverse={reverse}: y err {err_y:.3e} (tol {K1_TOL_Y} + "
                  f"{K1_TOL_Y} |y|), ld rel err {err_ld:.3e} (tol {K1_TOL_LD})", flush=True)
            check(ok_y and err_ld <= K1_TOL_LD and bool(torch.isfinite(y).all()),
                  f"K1 vs plain at {shape} reverse={reverse}")
            check(torch.equal(y, y2) and torch.equal(ld, ld2), f"K1 deterministic at {shape}")
            worst = max(worst, err_y)
        y, _ = coupling_apply(x, raw, t)
        x_rec, _ = coupling_apply(y, raw, t, reverse=True)
        err_rt = (x_rec - x).abs().max().item()
        print(f"  {shape} roundtrip err {err_rt:.3e} (tol {K1_TOL_RT})", flush=True)
        check(err_rt <= K1_TOL_RT, f"K1 roundtrip at {shape}")
        for reverse in (False, True):
            grads = []
            for fn in (coupling_apply, coupling_apply_reference):
                xs = [a.clone().requires_grad_() for a in (x, raw, t)]
                y, ld = fn(*xs, reverse=reverse)
                (y.pow(2).sum() + 0.5 * ld.pow(2).sum()).backward()
                grads.append([a.grad for a in xs])
            err_g = max((a - b).abs().max().item() for a, b in zip(*grads))
            ok_g = all(bool(((a - b).abs() <= K1_TOL_GRAD + K1_TOL_GRAD * b.abs()).all())
                       for a, b in zip(*grads))
            print(f"  {shape} reverse={reverse} gradients of sum y^2 + sum ld^2 / 2: max abs "
                  f"err {err_g:.3e} (tol {K1_TOL_GRAD} + {K1_TOL_GRAD} |g|)", flush=True)
            check(ok_g, f"K1 gradients at {shape} reverse={reverse}")

        # Device time (graph replay of 100 launches) and, for the record,
        # back-to-back eager calls, which the host's cost per call bounds.
        ms = time_graph_ms(lambda: coupling_apply(x, raw, t), 100)
        plain_ms = time_graph_ms(lambda: coupling_apply_reference(x, raw, t), 100)
        eager_ms = time_ms(lambda: coupling_apply(x, raw, t), 200)
        plain_eager_ms = time_ms(lambda: coupling_apply_reference(x, raw, t), 200)
        b, d = shape[0], math.prod(shape[1:])
        nbytes = 16 * b * d + 4 * b  # x, raw, t read once; y, ld written once
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        t_ops = K1_OPS_PER_ELEMENT * b * d / PEAK_F32_FLOPS * 1e3
        shapes.append(dict(shape=list(shape), ms=ms, plain_ms=plain_ms,
                           bound_ms=max(t_ops, t_bytes),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           gbytes_per_s=nbytes / ms / 1e6, eager_ms=eager_ms,
                           plain_eager_ms=plain_eager_ms))
        print(f"  {shape} K1 {ms:.5f} ms/launch in a graph (bound {max(t_ops, t_bytes):.5f} "
              f"ms, {nbytes / ms / 1e6:.0f} GB/s), plain version {plain_ms:.5f} ms; eager "
              f"calls {eager_ms:.5f} / plain {plain_eager_ms:.5f} ms", flush=True)
    mean = lambda k: sum(s[k] for s in shapes) / len(shapes)  # noqa: E731
    return {
        "name": "coupling_apply",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "max_abs_err": worst,
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in shapes) else "operations",
        "library_ms": None,  # no one PyTorch call computes it
        "shapes": shapes,
    }


def k1_path_phase(dev) -> int:
    """K1's path: the entry point as its callers use it (bench.py's
    parity microbench): a forward and a reverse at the flagship shape,
    then a gradient through both. Returns the launches counted."""
    import torch

    from tpuflow_torch.kernels import coupling_apply as ka

    gen = torch.Generator().manual_seed(8)
    x, raw, t = ((scale * torch.randn(K1_SHAPES[0], generator=gen)).to(dev).requires_grad_()
                 for scale in (1.0, 0.5, 0.5))
    ka.launches = 0
    y, ld_f = ka.coupling_apply(x, raw, t, use_pallas=True)
    x_rec, ld_r = ka.coupling_apply(y, raw, t, reverse=True, use_pallas=True)
    (x_rec.pow(2).sum() + (ld_f + ld_r).sum()).backward()
    torch.cuda.synchronize()
    launches = ka.launches
    err = (x_rec - x).abs().max().item()
    finite = all(bool(torch.isfinite(a.grad).all()) for a in (x, raw, t))
    print(f"  entry point at {K1_SHAPES[0]}: launches {launches} (expected 2), roundtrip err "
          f"{err:.3e}, gradients finite {finite}", flush=True)
    check(launches == 2 and err <= K1_TOL_RT and finite, "K1 entry-point path")
    return launches


def train_phase(cfg, dev, overrides=()) -> dict:
    """Training at full width through the CLI, in-process: K2 launches
    counted over the run, every window's bpd and grad norm finite, the
    parameters changed, and a resume from the saved checkpoint.
    ``overrides`` (key=value) shrink the model for a rehearsal."""
    import csv
    import tempfile

    import torch

    from tpuflow_torch.cli.train import main as train_main
    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, init_lstm_state
    from tpuflow_torch.train import Checkpointer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        args = [*TRAIN_ARGS, *overrides, f"train.checkpoint_dir={tmp}", "--device", dev.type]
        tcfg = load_case("backward-step", parse_cli_overrides(args[:-2]))
        d = tcfg.data
        win_per_epoch = (d.n_train_traj // d.batch_size) * (d.train_steps // d.window)
        n_windows = TRAIN_EPOCHS * win_per_epoch
        per_step = tcfg.model.n_scales * tcfg.model.n_flow_steps

        coupling_fused.launches = 0
        t0 = time.perf_counter()
        final = train_main(["backward-step", *args, f"train.epochs={TRAIN_EPOCHS}"])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = coupling_fused.launches
        # data_init's one forward, then every timestep of every window.
        expected = per_step * (1 + d.window * n_windows)
        print(f"  {n_windows} windows (batch {d.batch_size}, window {d.window}) in "
              f"{elapsed:.2f} s with set-up; last epoch {final['windows_per_sec']:.3f} "
              f"windows/s; K2 launches {launches} (expected {per_step} x (1 + "
              f"{d.window} x {n_windows}))", flush=True)
        check(launches == expected, "K2 launch count of training")

        with open(f"{tmp}/backward-step/train_log.csv") as f:
            rows = list(csv.DictReader(f))
        vals = [(float(r["bpd"]), float(r["grad_norm"])) for r in rows]
        print("  per window (bpd, grad norm): "
              + ", ".join(f"({b:.4f}, {g:.3f})" for b, g in vals), flush=True)
        check(len(vals) == n_windows and all(math.isfinite(v) for pair in vals for v in pair),
              "finite bpd and grad norm in every window")

        saved = Checkpointer(f"{tmp}/backward-step").restore(map_location=dev)["model"]
        init = TMGlow(tcfg.model, device=dev, seed=tcfg.train.seed)
        ds = load_dataset(tcfg.data, tcfg.model)
        idx = next(ds.batch_indices(d.seed, d.batch_size))
        init.data_init(torch.from_numpy(ds.hf[idx, 0]).to(dev),
                       torch.from_numpy(ds.lf[idx, 0]).to(dev),
                       init_lstm_state(tcfg.model, d.batch_size, dev))
        names = [n for n, _ in init.named_parameters()]
        unchanged = [n for n in names if torch.equal(init.state_dict()[n], saved[n])]
        print(f"  parameters changed: {len(names) - len(unchanged)} of {len(names)} tensors",
              flush=True)
        check(not unchanged, f"every parameter changed (unchanged: {unchanged[:5]})")

        coupling_fused.launches = 0
        resumed = train_main(["backward-step", *args, f"train.epochs={TRAIN_EPOCHS + 1}"])
        torch.cuda.synchronize()
        resume_launches = coupling_fused.launches
        print(f"  resume: epoch {resumed['epoch']}, bpd {resumed['mean_bpd']:.4f}, K2 launches "
              f"{resume_launches} (expected {per_step * d.window * win_per_epoch})", flush=True)
        check(resumed["epoch"] == TRAIN_EPOCHS + 1 and math.isfinite(resumed["mean_bpd"])
              and resume_launches == per_step * d.window * win_per_epoch, "resume")
    return {"launches": launches, "windows_per_sec": final["windows_per_sec"],
            "resume_launches": resume_launches}


def train_parity_phase(cfg, dev) -> dict:
    """One f32 window at full width, batch 2, window 2: the loss and every
    gradient with the kernel forward against the same window with the
    plain forward (the plain version swapped in for the kernel)."""
    import dataclasses

    import torch

    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, init_lstm_state
    from tpuflow_torch.train import window_bpd_fn

    mcfg = dataclasses.replace(cfg.model, compute_dtype="float32")
    ds = load_dataset(dataclasses.replace(cfg.data, n_train_traj=2, train_steps=2), mcfg)
    lf, hf = torch.from_numpy(ds.lf).to(dev), torch.from_numpy(ds.hf).to(dev)
    model = TMGlow(mcfg, device=dev, seed=0)
    model.data_init(hf[:, 0], lf[:, 0], init_lstm_state(mcfg, 2, dev))
    perturb_(model, 6)  # non-zero coupling heads and priors
    loss_fn = window_bpd_fn(model)

    def window():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(lf, hf, init_lstm_state(mcfg, 2, dev))
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    before = coupling_fused.launches
    loss_k, g_k = window()
    per_step = mcfg.n_scales * mcfg.n_flow_steps
    check(coupling_fused.launches - before == 2 * per_step, "kernel window launched K2")
    kernel = coupling_fused.fused_coupling
    coupling_fused.fused_coupling = coupling_fused.fused_coupling_reference
    try:
        loss_p, g_p = window()
    finally:
        coupling_fused.fused_coupling = kernel
    err_loss = abs(loss_k - loss_p) / max(1.0, abs(loss_p))
    errs = sorted(((g_k[n] - gp).abs().max().item() / max(1.0, gp.abs().max().item()), n)
                  for n, gp in g_p.items())
    worst = errs[-1][0]
    print(f"  f32 window, kernel vs plain forward: loss {loss_k:.6f} vs {loss_p:.6f} (rel err "
          f"{err_loss:.3e}, tol {TRAIN_TOL_LOSS}); gradient err x max(1, max|g|) (tol "
          f"{TRAIN_TOL_GRAD}), worst of {len(errs)} tensors: "
          + ", ".join(f"{n} {e:.3e}" for e, n in errs[:-4:-1]), flush=True)
    check(err_loss <= TRAIN_TOL_LOSS and worst <= TRAIN_TOL_GRAD,
          "f32 training window, kernel vs plain forward")
    return {"loss_rel_err": err_loss, "grad_rel_err": worst}


def train_share_phase(cfg, dev) -> dict:
    """Windows/s of one training window at full width (bf16, batch 8,
    window 8), and the shares of K2's forward launches and of its
    recompute backward in it (CUDA events around each call, in a second
    window after the uninstrumented one)."""
    import dataclasses

    import torch

    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, init_lstm_state
    from tpuflow_torch.train import make_optimizer, train_step

    d = dataclasses.replace(cfg.data, n_train_traj=8, train_steps=8)
    ds = load_dataset(d, cfg.model)
    lf, hf = torch.from_numpy(ds.lf).to(dev), torch.from_numpy(ds.hf).to(dev)
    model = TMGlow(cfg.model, device=dev, seed=cfg.train.seed)
    model.data_init(hf[:, 0], lf[:, 0], init_lstm_state(cfg.model, 8, dev))
    opt, sched = make_optimizer(model.parameters(), cfg.train.lr, cfg.train.lr_decay)

    def window():
        t0 = time.perf_counter()
        _, m = train_step(model, opt, sched, cfg.train.grad_clip, lf, hf,
                          init_lstm_state(cfg.model, 8, dev))
        torch.cuda.synchronize()
        check(math.isfinite(m["bpd"].item()), "finite bpd in the timed window")
        return time.perf_counter() - t0

    window()  # warm-up: cuDNN plans, allocator
    times = [window() for _ in range(2)]
    plain_s = min(times)

    fwd, bwd = [], []
    kernel, backward = coupling_fused.fused_coupling, coupling_fused._FusedCoupling.backward

    def pair():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed_kernel(*a, **k):
        s, e = pair()
        s.record()
        out = kernel(*a, **k)
        e.record()
        fwd.append((s, e))
        return out

    def timed_backward(ctx, gy, gld):
        s, e = pair()
        s.record()
        out = backward(ctx, gy, gld)
        e.record()
        bwd.append((s, e))
        return out

    coupling_fused.fused_coupling = timed_kernel
    coupling_fused._FusedCoupling.backward = staticmethod(timed_backward)
    try:
        timed_s = window()
    finally:
        coupling_fused.fused_coupling = kernel
        coupling_fused._FusedCoupling.backward = staticmethod(backward)
    per = cfg.model.n_scales * cfg.model.n_flow_steps * d.window
    check(len(fwd) == per and len(bwd) == per, "K2 calls of the instrumented window")
    fwd_ms = sum(s.elapsed_time(e) for s, e in fwd)
    bwd_ms = sum(s.elapsed_time(e) for s, e in bwd)
    out = {"windows_per_sec": 1.0 / plain_s, "window_ms": plain_s * 1e3,
           "instrumented_window_ms": timed_s * 1e3, "k2_fwd_ms": fwd_ms,
           "k2_bwd_ms": bwd_ms, "k2_fwd_share": fwd_ms / (timed_s * 1e3),
           "k2_bwd_share": bwd_ms / (timed_s * 1e3)}
    print(f"  window (batch 8 x 8 steps, bf16): {plain_s * 1e3:.1f} ms, "
          f"{out['windows_per_sec']:.3f} windows/s (best of {len(times)}); instrumented "
          f"{timed_s * 1e3:.1f} ms: K2 forward {fwd_ms:.1f} ms "
          f"({100 * out['k2_fwd_share']:.1f}%), K2 recompute backward {bwd_ms:.1f} ms "
          f"({100 * out['k2_bwd_share']:.1f}%)", flush=True)
    return out


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
        device_name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}; device {device_name}")
        print(smi, flush=True)

    with phase("build"):
        sources = ("coupling_fused", "coupling_apply")
        _build.build(*sources)  # one nvcc per source, started together
        for source in sources:
            _build.load(source)

    case = load_case("backward-step")
    cfg = case.model
    with phase("kernel vs plain"):
        k2 = kernel_phase(cfg, dev)

    with phase("K1 vs plain"):
        k1 = k1_phase(dev)
        k1["launches"] = k1_path_phase(dev)

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

    with phase("train"):
        train = train_phase(case, dev)
        train.update(train_parity_phase(case, dev))
        train.update(train_share_phase(case, dev))

    k2["launches"] = launches
    k2["launches_by_path"] = {"rollout": launches, "train": train.pop("launches")}
    k2["train"] = train
    print(smi)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
