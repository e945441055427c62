#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tpuflow_torch) on one GPU.

    python3 chip_smoke.py               # 64 members x 16 steps
    python3 chip_smoke.py --steps 100   # the 64 x 100 baseline rollout

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per source, all started together, ``-Xptxas -v`` printed),
checks that the bf16 conv kernel's SASS holds tensor-core (HMMA)
instructions and K1's 128-bit global loads, holds each kernel against
its plain PyTorch version on the card and times it beside its bound (K2
in both of its bf16 numerics, ``model.use_pallas`` false and true, each
against the plain version of the same numerics and timed beside the
other, also beside cuDNN's bf16 convs, a yardstick the port never calls,
and at the training batch; K1 with the L2 cold and warm), and drives
the port's paths, each with the launch counts set to 0 just before it
and read just after:

  * the ensemble rollout of the backward-step case at full width, from a
    seeded random init, through the fused coupling K2 in the preset's
    numerics (the JAX default path's), and its rate beside the fused
    numerics' (phase "slice");
  * training at full width through the CLI, ``python -m
    tpuflow_torch.cli.train``, in-process on a small fixture: every
    coupling forward launches K2, its backward differentiates the plain
    version; then a resume from the saved checkpoint (phase "train");
  * the coupling-apply entry point ``kernels.coupling_apply``, forward,
    reverse and gradient, through K1 (phase "K1 vs plain");
  * the rollout CLI, ``python -m tpuflow_torch.cli.rollout``, in-process
    on a checkpoint in the exporter's format with a per-scale learned
    tau, 64 members, its LF input wrap-tiled (phase "rollout CLI");
  * each committed trained checkpoint (``weights/r5_v3_deep_ft``, the
    backward-step flagship, and ``weights/r5_cyl_ft``, the cylinder-array
    one) through the rollout CLI's compute half at its preset (64 members
    x 100 steps; 4 x 100 at 96 x 96) on its learned tau, finite with the
    overflow redraw off, K2 timed on the inputs the trained nets give it;
    its f32 rollout on the CPU's draws, card against CPU, and its bf16
    held-out bits/dim in its checkpoint's numerics (the default path's) at
    8 steps and at the evaluator's 64, all held to the CPU's
    ``reference.json`` beside the weights; the 64-step bits/dim in the
    fused numerics beside the TPU's, for information (phases "flagship
    weights/...");
  * the deployment chain on the backward-step flagship: the evaluator at
    the preset (K2 at B = 256; ``test_bpd`` held to ``reference.json``,
    every metric finite), the export of the serving artifact from the
    evaluation's directory (its sidecar carrying the fitted calibration),
    the server loading it, 64 members x 100 steps served against the
    eager rollout on the same seed, plain and calibrated, timed in
    interleaved pairs with each step's kernels profiled, and one
    calibrated HTTP request (phase "deploy");
  * the ``cylinder-array`` case at its preset (4 members, 100 steps,
    96 x 96), with K2 held against its plain version and timed at the
    case's shapes (phase "cylinder");
  * the batched rollout, 4 trajectories x 16 members as one batch,
    against a loop of single rollouts at f32, and timed at bf16 (phase
    "batched");
  * the overflow redraw: a forced member redrawn, the others untouched,
    and the rollout's rate with the redraw off and on (phase "redraw");
  * the evaluator, ``python -m tpuflow_torch.cli.evaluate``, in-process
    at the backward-step preset (64 members, 4 trajectories per batched
    rollout, so K2 runs at B = 256, 32 calibration steps, 256 reference
    steps) on a checkpoint in the exporter's format, after K2 is held
    against its plain version at B = 256 (phase "evaluate");
  * the sample-path fine-tune, ``python -m tpuflow_torch.tools.finetune``,
    in-process at the flagship's recipe on the "train" phase's fixture
    from an exporter-format file of the seeded init: K2 forward at B = 4
    and reverse at B = 24 under autograd, held against the plain version
    in one f32 window and timed alone; the output's learned tau served by
    the rollout CLI's compute half; remat's peak memory and seconds
    (phase "finetune").
  * data parallelism at full width, f32: two ranks, child processes
    sharing the card over gloo, each training on half of a batch-8 window,
    held against one process on the whole batch, both through K2; then an
    NCCL all-reduce of the gradients and an NCCL world of one through the
    training CLI (phase "data parallel");
  * the member split: K2 held against its plain version at the chunks'
    batches; 64 members as two chunks on a mesh of [card, card] against
    the flat rollout on one generator, and both timed (phase "split");
  * the data tier: the training fixture written to .tpf (and .h5 where
    h5py is installed), the streamed first batch held to the RAM loader's,
    training through the CLI with ``data.loader=stream`` against a RAM run
    of the same seed (phase "stream");
  * the serving artifact: the rollout exported with ``torch.export`` (K2 as
    the registered operator ``tpuflow_torch::fused_coupling``) at f32 and
    bf16, loaded, its stats held against the eager rollout on the same
    seeded generator, served against eager steps/s, and one HTTP round
    trip through ``tools/serve.py`` (phase "serve");
  * the rollout tools at full width (``sweep_members``, ``probe_width`` at
    coupling width 64 and 128 with K2 held against its plain version at
    128, ``probe_tau_stability``, ``sweep_temperature.sweep``,
    ``probe_spectrum``) and ``doctor`` (phase "tools").

The rollout CLI and the evaluator draw their figures when matplotlib is
installed, and the phases check the files; without it they run the
CLIs' compute halves and print that the figures were not drawn.

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
import importlib.util
import itertools
import json
import math
import pathlib
import subprocess
import re
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
# K1's cold timing rotates its launches through input sets this many bytes
# apart, twice the H100's 50 MB L2: a flagship call (4.2-16.8 MB) fits in
# the L2, so repeated launches on one set would read from it, not HBM.
L2_COLD_BYTES = 100e6
K2_SOURCE = "tpuflow_torch/kernels/csrc/coupling_fused.cu"
K2_REPLACES = "tpuflow/kernels/coupling_fused.py:119"
# Kernel vs plain version: y max abs error, logdet error relative to
# max(1, |logdet|). f32: both accumulate in f32, so only the summation
# order differs. bf16, either numerics: same rounding of inputs and
# weights, but a value near a bf16 rounding boundary (a relu feature; in
# the default numerics every conv output and sum) can round one ulp
# apart; 5e-3 leaves room for that at these shapes (worst seen on an
# H100, fused numerics: 9.2e-4) and still catches a fault of the bf16
# instantiation alone.
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-3, 1e-3)}
# bf16 default numerics: the share of y values more than 1e-5 apart. Both
# sides round the head (raw, t) to bf16, so only a value whose f32 sum
# lies on a rounding boundary differs, with the flips it spreads through
# the later convs (0.39 % at B = 2, scale 0, on the CPU with f64 against
# f32 sums; 0.2 % to 2.05 % kernel against plain on an H100), where a
# rounding point missed moves about half of y: a missed bias, h0c or
# running-sum rounding moves every head value (the fused numerics, all of
# them missed: 49.5 %; test_torch_numerics.py prints both). The max error
# alone, one ulp of a head value either way, does not tell the two apart.
DEFAULT_SHARE_TOL = 0.1
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
# The rollout CLI phase: 24 steps over the fixture's 16 stored ones, and a
# per-scale tau of the flagship's magnitude in the checkpoint's meta.
CLI_STEPS, CLI_TAU = 24, (0.87, 0.86, 0.865)
# f32 rollout stats, kernel on the card vs plain on the CPU, relative to
# max(1, max |reference|): 24 reverse couplings carry the summation-order
# differences of every conv into the sampled fields.
SLICE_TOL = 1e-4
SMI = ["card not read"]  # nvidia-smi's name and power limit, set by main()
# The evaluator's figures (cli/evaluate.py) besides vorticity_tNNNN.png,
# and its artefacts.
EVAL_FIGURES = ("nll_curve.png", "energy_spectrum.png", "reliability.png",
                "fluctuation_pdf.png", "reliability_holdout.png", "tke.png")
EVAL_ARTEFACTS = ("eval_metrics.json", "spread_field.npy", "spectral_filter.npz",
                  "quantile_map.npz")
# The fine-tune phase: the flagship's recipe (runs/r5_v3_deep_ft meta
# "finetune": 6 members, lambdas 0.3 / 0.02 / 0.5, scope nets, lr 1e-5),
# batch 4, a learned tau, bf16 nets, over the "train" phase's fixture
# (TRAIN_ARGS: 8 trajectories x 16 steps, window 8) for 2 epochs: 2
# batches x 2 windows each. Cut: eval.ref_steps 256 -> 64 (the spectral
# targets' converged references, NumPy on the host).
FT_ARGS = ["finetune.lambda_crps=0.3", "finetune.lambda_spec=0.02",
           "finetune.lambda_disp=0.5", "finetune.train_scope=nets", "finetune.lr=1e-5",
           "finetune.n_members=6", "finetune.batch_size=4", "finetune.learn_tau=true",
           "finetune.epochs=2", "eval.ref_steps=64"]
FT_SERVE_STEPS = 16
# Data parallelism: two ranks on one card over gloo, full width f32; the
# one-process window on the full batch holds them (loss 1e-5 relative, each
# gradient 1e-4 x max(1, max |g|): the ranks' halves run through K2 at
# batch 4 against batch 8, and their average sums in another order).
DP_TOL_LOSS, DP_TOL_GRAD = 1e-5, 1e-4
DP_WINDOWS = 3  # per rank: the held window, then two timed ones
# The member split against the flat rollout on one generator: at f32 only
# the chunks' batch sizes differ; at bf16 a conditioning conv whose cuDNN
# algorithm changes with the batch may round a feature one ulp apart.
SPLIT_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# A streamed training epoch against the same epoch from RAM on the same
# constants: the store's fused (x - mean) * (1 / std) and RAM's
# (x - mean) / std round an input an ulp apart at most.
STREAM_TOL_BPD = 1e-6
# The streamed batch on the store's own constants against RAM's: the same
# ulp apart, on inputs of order 1 (the CPU tests' bound, test_torch_tpf.py).
STREAM_TOL_NORM = 1e-6
# The committed trained weights on the card, each beside the CPU's
# reference.json: the backward-step flagship (runs/r5_v3_deep_ft step 16)
# and the cylinder-array one (runs/r5_cyl_ft step 10), each at its preset
# (64 members x 100 steps; 4 x 100). The bf16 held-out bits/dim (8 steps,
# and the evaluator's own step count) is held to the CPU's at 1e-3
# relative, the tolerance of the port's bf16 numerics against JAX's
# (tests/test_torch_evaluate.py BF16_TOL); the f32 rollout at SLICE_TOL.
FLAGSHIP_DIRS = ("weights/r5_v3_deep_ft", "weights/r5_cyl_ft")
FLAGSHIP_TOL_BPD = 1e-3
# The TPU's evaluation of each (runs/r5_v3_deep_ft/eval/backward-step/ and
# runs/r5_cyl_ft/eval64/cylinder-array/ eval_metrics.json, "backend":
# "tpu"; 64 steps x 4 test trajectories, default numerics), printed beside
# the card's for information, not as a gate: XLA on the TPU fuses (and
# rounds) otherwise, and the card draws from a CUDA generator.
TPU_EVAL = {"weights/r5_v3_deep_ft": {"test_bpd": -7.75687313079834,
                                      "spread_scale": 1.2155625820159912},
            "weights/r5_cyl_ft": {"test_bpd": -9.248455047607422,
                                  "spread_scale": 3.65617299079895}}


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# K2's two numerics at bf16 (``model.use_pallas``, ``PackedNet.fused``):
# the JAX default path's, every conv output and sum rounded to bf16 (the
# presets' and every committed checkpoint's), and the fused coupling's.
NUMERICS = ("default", "fused")


def numerics_of(cfg) -> str:
    """The numerics a model config selects."""
    return "fused" if cfg.use_pallas else "default"


def has_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


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


def time_cold_ms(fn, sets, reps: int) -> float:
    """Device time per call of ``fn`` with the L2 cold: as
    :func:`time_graph_ms`, but the calls rotate through the argument tuples
    ``sets`` and each keeps its own outputs, so a call finds its inputs
    last touched ``len(sets)`` calls ago. ``reps`` is rounded up to a
    multiple of ``len(sets)``, so that holds across replays too."""
    calls, outs = itertools.cycle(sets), []
    reps = -(-reps // len(sets)) * len(sets)
    return time_graph_ms(lambda: outs.append(fn(*next(calls))), reps)


def random_coupling(b, h, w, ca, width, growth, layers, dtype, h0c_batch, gen, dev,
                    fused=False):
    """Inputs and packed weights at lecun scale, with a random non-zero
    head (a zero head makes the coupling a constant scale), in the
    numerics ``fused`` (the presets' default path: False)."""
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
                   (0.1 * torch.randn(total0, generator=gen)).to(dev), dtype, fused=fused)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev)
    h0c = None
    if h0c_batch:
        h0c = (0.5 * torch.randn(h0c_batch, h, w, width, generator=gen)).to(dev, dtype)
    return xa, xb, h0c, net


def kernel_phase(cfg, dev, b=N_MEMBERS, b_train=8):
    """K2 against its plain version at the rollout's three shapes with
    ``b`` members and with ``b_train`` (the training batch), in both
    numerics at bf16, its f32 roundtrip, and its time in both numerics
    (also at ``b_train`` unless None); returns the kernels-line entry
    (without launches)."""
    import torch

    from tpuflow_torch.kernels.coupling_fused import fused_coupling
    from tpuflow_torch.models.tmglow import scale_shapes

    gen = torch.Generator().manual_seed(1)
    width, growth, layers = cfg.coupling_width, cfg.growth_rate, cfg.coupling_layers
    worst = max(k2_parity(cfg, dev, bb, gen) for bb in (b, b_train) if bb)
    c = cfg.channels
    for l, (h, w) in enumerate(scale_shapes(cfg)):
        c = 4 * c if l == 0 else 2 * c  # squeeze x4, after a split's halving
        ca = c // 2
        # Invertibility through the kernel: reverse(forward(x)) at f32.
        xa, xb, h0c, net = random_coupling(b, h, w, ca, width, growth, layers,
                                           torch.float32, b, gen, dev)
        y, _ = fused_coupling(xa, xb, h0c, net)
        x_rec, _ = fused_coupling(y[..., :ca].contiguous(), y[..., ca:].contiguous(), h0c,
                                  net, reverse=True)
        err_rt = (x_rec[..., :ca] - xa).abs().max().item()
        print(f"  scale {l} f32 roundtrip err {err_rt:.3e} (tol {ROUNDTRIP_TOL})", flush=True)
        check(err_rt <= ROUNDTRIP_TOL, f"K2 roundtrip at scale {l}")
    shapes = k2_times(cfg, dev, b, gen)
    for s in shapes if b_train else ():
        _, h, w, ca = s["shape"]
        xa, xb, h0c, net = random_coupling(b_train, h, w, ca, width, growth, layers,
                                           torch.bfloat16, b_train, gen, dev, cfg.use_pallas)
        by = {}
        for name in NUMERICS:  # each numerics beside the other, same inputs
            n = net._replace(fused=name == "fused")
            by[name] = time_graph_ms(lambda: fused_coupling(xa, xb, h0c, n, reverse=True), 20)
        s.update(ms_b8=by[numerics_of(cfg)], ms_b8_by_numerics=by,
                 bound_ms_b8=k2_bound(xa, xb, h0c, net, growth, layers)[0])
        print(f"  scale {s['scale']} K2 at B = {b_train}: "
              + ", ".join(f"{k} {v:.5f}" for k, v in by.items())
              + f" ms/launch in a graph (bound {s['bound_ms_b8']:.5f})", flush=True)
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
        # No one PyTorch call computes the coupling (convs, growth sums,
        # affine and logdet); cudnn_chain_ms in each shape times its convs.
        "library_ms": None,
        "shapes": shapes,
    }


def k2_parity(cfg, dev, b, gen=None) -> float:
    """K2 against its plain version of the same numerics at the three
    scales' shapes with ``b`` members, f32 and bf16 (bf16 in both numerics:
    the default path's and the fused coupling's; at f32 they are one), the
    conditioning batched 1, ``b`` or absent, both directions; returns the
    worst y error."""
    import torch

    from tpuflow_torch.kernels.coupling_fused import fused_coupling, fused_coupling_reference
    from tpuflow_torch.models.tmglow import scale_shapes

    gen = torch.Generator().manual_seed(1) if gen is None else gen
    width, growth, layers = cfg.coupling_width, cfg.growth_rate, cfg.coupling_layers
    worst, c = 0.0, cfg.channels
    for l, (h, w) in enumerate(scale_shapes(cfg)):
        c = 4 * c if l == 0 else 2 * c  # squeeze x4, after a split's halving
        ca = c // 2
        for dtype, numerics in ((torch.float32, (numerics_of(cfg),)),
                                (torch.bfloat16, NUMERICS)):
            tol_y, tol_ld = TOL[str(dtype).removeprefix("torch.")]
            for h0c_batch in (1, b, 0):
                xa, xb, h0c, net = random_coupling(b, h, w, ca, width, growth, layers,
                                                   dtype, h0c_batch, gen, dev)
                for name, reverse in itertools.product(numerics, (False, True)):
                    n = net._replace(fused=name == "fused")
                    y, ld = fused_coupling(xa, xb, h0c, n, reverse=reverse)
                    y_ref, ld_ref = fused_coupling_reference(xa, xb, h0c, n, reverse=reverse)
                    torch.cuda.synchronize()
                    err_y = (y - y_ref).abs().max().item()
                    err_ld = ((ld - ld_ref).abs() / ld_ref.abs().clamp_min(1.0)).max().item()
                    fin = bool(torch.isfinite(y).all() and torch.isfinite(ld).all())
                    rounded = dtype == torch.bfloat16 and name == "default"
                    share = ((y - y_ref).abs() > 1e-5).float().mean().item() if rounded else 0.0
                    print(f"  scale {l} B={b} {h}x{w} ca=cb={ca} {dtype} {name} "
                          f"h0c_batch={h0c_batch} reverse={reverse}: y err {err_y:.3e} "
                          f"(tol {tol_y}), ld rel err {err_ld:.3e} (tol {tol_ld})"
                          + (f", y share > 1e-5 {share:.2e} (tol {DEFAULT_SHARE_TOL})"
                             if rounded else ""), flush=True)
                    check(fin and err_y <= tol_y and err_ld <= tol_ld
                          and share <= DEFAULT_SHARE_TOL,
                          f"K2 vs plain at scale {l} B={b} {dtype} {name} "
                          f"h0c_batch={h0c_batch} reverse={reverse}")
                    worst = max(worst, err_y)
    return worst


def k2_times(cfg, dev, b, gen=None, reverse=True) -> list[dict]:
    """K2 at the rollout's configuration (bf16 nets, reverse, the
    conditioning batched over the ``b`` members; ``reverse=False``: the
    NLL forward's) at the three scales' shapes: device time per launch
    from a CUDA graph of 20 launches (back-to-back eager calls would also
    hold the host's ~0.1 ms per call) in each numerics on the same inputs
    (``ms``: the config's, ``model.use_pallas``), the eager time beside
    it, its bound, the plain version's time and cuDNN's five bf16 convs (a
    yardstick the port never calls)."""
    import torch

    from tpuflow_torch.kernels.coupling_fused import fused_coupling, fused_coupling_reference
    from tpuflow_torch.models.tmglow import scale_shapes

    gen = torch.Generator().manual_seed(1) if gen is None else gen
    width, growth, layers = cfg.coupling_width, cfg.growth_rate, cfg.coupling_layers
    shapes, c = [], cfg.channels
    for l, (h, w) in enumerate(scale_shapes(cfg)):
        c = 4 * c if l == 0 else 2 * c
        ca = c // 2
        xa, xb, h0c, net = random_coupling(b, h, w, ca, width, growth, layers,
                                           torch.bfloat16, b, gen, dev, cfg.use_pallas)
        by = {}
        for name in NUMERICS:  # each numerics beside the other, same inputs
            n = net._replace(fused=name == "fused")
            by[name] = time_graph_ms(lambda: fused_coupling(xa, xb, h0c, n, reverse=reverse), 20)
        ms = by[numerics_of(cfg)]
        eager_ms = time_ms(lambda: fused_coupling(xa, xb, h0c, net, reverse=reverse), 20)
        plain_ms = time_graph_ms(
            lambda: fused_coupling_reference(xa, xb, h0c, net, reverse=reverse), 20)
        chain_ms = cudnn_chain_ms(b, h, w, ca, width, growth, layers, dev)
        bound_ms, bound_by, flops, nbytes = k2_bound(xa, xb, h0c, net, growth, layers)
        shapes.append(dict(scale=l, shape=[b, h, w, ca], reverse=reverse,
                           numerics=numerics_of(cfg), ms=ms, ms_by_numerics=by,
                           eager_ms=eager_ms, plain_ms=plain_ms, cudnn_chain_ms=chain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6))
        print(f"  scale {l} K2 {'reverse' if reverse else 'forward'} at B = {b}: "
              + ", ".join(f"{k} {v:.5f}" for k, v in by.items())
              + f" ms/launch in a graph, {eager_ms:.5f} eager ({numerics_of(cfg)}) "
              f"(bound {bound_ms:.5f} ms by {bound_by}, {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB, {100 * bound_ms / ms:.1f}% of the bound reached); plain "
              f"version {plain_ms:.4f} ms (not a yardstick); cuDNN's five bf16 convs "
              f"{chain_ms:.5f} ms (a yardstick)", flush=True)
        del xa, xb, h0c, net
    return shapes


def k2_bound(xa, xb, h0c, net, growth, layers):
    """(bound ms, what bounds it, FLOPs, bytes) of one K2 launch on these
    inputs: each input read once, y and ld written once, against the
    tensor cores' bf16 rate and the memory rate."""
    b, h, w, ca = xa.shape
    flops = 2 * b * h * w * coupling_macs_per_pixel(ca, xb.shape[-1], net.width, growth, layers)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (xa, xb, h0c, net.win0, net.b0, *net.wjs, net.bj0) if t is not None)
    nbytes += b * h * w * (ca + xb.shape[-1]) * 4 + b * 4  # y and ld
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, nbytes


def cudnn_chain_ms(b, h, w, ca, width, growth, layers, dev) -> float:
    """Yardstick, never called by the port: the coupling's five 3x3 convs
    (conv_in, joint_0..L) as cuDNN bf16 ``F.conv2d`` calls in
    channels_last, at one member batch, device time from a CUDA graph."""
    import torch
    import torch.nn.functional as F

    total0 = layers * growth + 2 * ca
    io = [(ca, width)] + [(width if j == 0 else growth, total0 - j * growth)
                          for j in range(layers + 1)]
    cl = torch.channels_last
    xs = [torch.randn(b, cin, h, w, device=dev, dtype=torch.bfloat16).to(memory_format=cl)
          for cin, _ in io]
    ws = [(0.1 * torch.randn(cout, cin, 3, 3, device=dev, dtype=torch.bfloat16))
          .to(memory_format=cl) for cin, cout in io]

    def chain():
        for x, wt in zip(xs, ws):
            F.conv2d(x, wt, padding=1)

    return time_graph_ms(chain, 20)


def sass_count(lib, kernel: str, opcode: str) -> dict[str, int] | None:
    """Instructions whose text matches the regex ``opcode`` in each
    function of ``lib`` whose name holds ``kernel`` (each instantiation),
    by ``cuobjdump -sass``; None without cuobjdump."""
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(exe).exists():
        return None
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if kernel in fn:
                counts[fn] = 0
        elif fn in counts and re.search(opcode, line):
            counts[fn] += 1
    return counts


def seeded_source(case, path, **meta) -> None:
    """Write, under ``path``, a checkpoint in ``tools/export_to_torch.py``'s
    format ("model", "norm", "meta"; no optimizer state) holding the seeded
    init of "slice" (perturbed by 0.004) and the normalization of the
    case's training split; ``meta`` adds to its meta."""
    import torch

    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.models import TMGlow, perturb_
    from tpuflow_torch.train import Checkpointer

    model = TMGlow(case.model, device="cpu", seed=0)
    perturb_(model, 1)
    norm = load_dataset(case.data, case.model, "train").norm
    Checkpointer(path).save(1, {
        "model": model.state_dict(),
        "norm": {k: torch.from_numpy(v) for k, v in norm.to_dict().items()},
        "meta": {"source": "chip_smoke.py seeded init", **meta},
    })


def slice_phase(cfg, dev, steps: int):
    """The main path: 64-member stats rollout at full width, bf16, in the
    preset's numerics (the default path's); then its rate beside the
    other numerics' on the same weights and draws."""
    import dataclasses

    import torch

    from tpuflow_torch.eval import make_ensemble_rollout
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, perturb_

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
    check(all(p.fused is cfg.use_pallas for row in model.glow.pack_couplings() for p in row),
          "every coupling of the main path in the config's numerics")

    # Both numerics' rates on the same weights and draws, the config's
    # before and after the other's (a host-bound rate moves within a call).
    other = TMGlow(dataclasses.replace(cfg, use_pallas=not cfg.use_pallas), device=dev, seed=0)
    other.load_state_dict(model.state_dict())
    rates: dict[str, list[float]] = {}
    for m in (model, other, model):
        r = make_ensemble_rollout(m, N_MEMBERS, TAU, "stats")
        t0 = time.perf_counter()
        r(lf, torch.Generator(dev).manual_seed(4))
        torch.cuda.synchronize()
        rates.setdefault(numerics_of(m.cfg), []).append(steps / (time.perf_counter() - t0))
    print("  rollout steps/s by numerics: " + ", ".join(
        f"{k} {' / '.join(f'{v:.3f}' for v in vs)}" for k, vs in rates.items())
        + f" [{SMI[0]}]", flush=True)

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
    return launches, steps / elapsed, per_launch, share, rates


def reference_phase(cfg, dev):
    """The rollout at f32 on a small input: kernel on the card against
    the plain version on the CPU, same weights and draws."""
    import dataclasses

    import torch

    from tpuflow_torch.eval import make_ensemble_rollout
    from tpuflow_torch.models import TMGlow, latent_shapes, perturb_

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = TMGlow(cfg32, device="cpu", seed=0)
    perturb_(cpu, 1)
    gpu = TMGlow(cfg32, device=dev, seed=0)
    gpu.load_state_dict(cpu.state_dict())
    n, steps = 2, 2
    gen = torch.Generator().manual_seed(5)
    lf = torch.randn(steps, *cfg.lf_shape, cfg.channels, generator=gen)
    eps = [[torch.randn(s, generator=gen) for s in latent_shapes(cfg, n)]
           for _ in range(steps)]
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

        # Device time per launch from a CUDA graph of ~100 launches: with
        # the L2 cold (the launches rotate through input sets 100 MB
        # apart), the kernel's and the plain version's; with the L2 warm
        # (every launch on one set); and, for the record, back-to-back
        # eager calls, which the host's cost per call bounds.
        b, d = shape[0], math.prod(shape[1:])
        nbytes = 16 * b * d + 4 * b  # x, raw, t read once; y, ld written once
        sets = [(x, raw, t)] + [tuple(torch.randn_like(a) for a in (x, raw, t))
                                for _ in range(math.ceil(L2_COLD_BYTES / nbytes))]
        ms = time_cold_ms(coupling_apply, sets, 100)
        plain_ms = time_cold_ms(coupling_apply_reference, sets, 100)
        # Yardstick, never called by the port: PyTorch's elementwise kernel
        # moving the same bytes (x + raw * t: three reads, one write), cold.
        addcmul_ms = time_cold_ms(torch.addcmul, sets, 100)
        ms_l2_warm = time_graph_ms(lambda: coupling_apply(x, raw, t), 100)
        eager_ms = time_ms(lambda: coupling_apply(x, raw, t), 200)
        plain_eager_ms = time_ms(lambda: coupling_apply_reference(x, raw, t), 200)
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        t_ops = K1_OPS_PER_ELEMENT * b * d / PEAK_F32_FLOPS * 1e3
        bound_ms = max(t_ops, t_bytes)
        shapes.append(dict(shape=list(shape), ms=ms, ms_l2_warm=ms_l2_warm, plain_ms=plain_ms,
                           addcmul_ms=addcmul_ms, bound_ms=bound_ms,
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           gbytes_per_s=nbytes / ms / 1e6, eager_ms=eager_ms,
                           plain_eager_ms=plain_eager_ms))
        print(f"  {shape} K1 {ms:.5f} ms/launch with the L2 cold ({len(sets)} input sets; "
              f"bound {bound_ms:.5f} ms, {100 * bound_ms / ms:.1f}% of it reached, "
              f"{nbytes / ms / 1e6:.0f} GB/s), {ms_l2_warm:.5f} ms with the L2 warm; plain "
              f"version {plain_ms:.5f} ms cold; torch.addcmul on the same bytes {addcmul_ms:.5f} "
              f"ms cold (a yardstick); eager calls {eager_ms:.5f} / plain {plain_eager_ms:.5f} ms",
              flush=True)
    mean = lambda k: sum(s[k] for s in shapes) / len(shapes)  # noqa: E731
    return {
        "name": "coupling_apply",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "max_abs_err": worst,
        "ms": mean("ms"),
        "ms_l2_warm": mean("ms_l2_warm"),
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
    from tpuflow_torch.models import TMGlow, init_lstm_state, perturb_
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


def rollout_cli_phase(dev, overrides=()) -> dict:
    """The serving path: ``python -m tpuflow_torch.cli.rollout`` in-process
    on a checkpoint in ``tools/export_to_torch.py``'s format ("model",
    "norm", "meta" with a per-scale ``learned_tau``; no optimizer state)
    that holds the seeded init of "slice" and the fixture's normalization;
    64 members, 24 steps over the 16 stored ones of the "train" phase's
    fixture (TRAIN_ARGS), so the LF input is wrap-tiled. K2 launches are
    counted over the CLI's warm-up and timed runs.

    The "train" phase's checkpoint (6 optimizer steps from its init)
    cannot serve here: its reverse overflows in every member at tau >=
    0.6, through the kernel and the CPU plain version alike."""
    import json
    import tempfile

    import numpy as np
    import torch

    from tpuflow_torch.cli import rollout as rollout_cli
    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.kernels import coupling_fused

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        args = [*TRAIN_ARGS, *overrides, f"train.checkpoint_dir={tmp}",
                f"eval.rollout_steps={CLI_STEPS}", f"eval.n_samples={N_MEMBERS}",
                f"eval.output_dir={tmp}/eval"]
        cfg = load_case("backward-step", parse_cli_overrides(args))
        check(cfg.eval.rollout_steps > cfg.data.train_steps,
              "the CLI run wrap-tiles its LF input")
        seeded_source(cfg, f"{tmp}/backward-step", learned_tau=list(CLI_TAU))
        per_step = cfg.model.n_scales * cfg.model.n_flow_steps

        coupling_fused.launches = 0
        if has_matplotlib():
            metrics = rollout_cli.main(["backward-step", *args, "--device", dev.type])
        else:
            print(f"  figures: not drawn on the card: matplotlib is not installed here, so "
                  f"{rollout_cli.PROG} stops at its start; ran its compute half", flush=True)
            metrics, _ = rollout_cli.rollout(cfg, dev)
        torch.cuda.synchronize()
        launches = coupling_fused.launches
        out = pathlib.Path(tmp) / "eval" / "backward-step"
        saved = json.loads((out / "rollout_metrics.json").read_text())
        with np.load(out / "rollout_stats.npz") as f:
            stats = {k: f[k] for k in f.files}
        files = {p.name for p in out.iterdir()}
    t_ref = cfg.data.train_steps
    t_mid = t_ref // 2
    shape = (CLI_STEPS, *cfg.model.hf_shape, cfg.model.channels)
    # Warm-up and timed runs, then the samples grid's 8 members to t_mid + 1.
    expected = per_step * (CLI_STEPS * 2 + t_mid + 1)
    print(f"  {N_MEMBERS} members x {CLI_STEPS} steps ({t_ref} stored, wrap-tiled), learned tau "
          f"{saved['temperature']}: {saved['rollout_steps_per_sec']:.3f} steps/s (the CLI's "
          f"timed run); K2 launches {launches} (expected {per_step} x ({CLI_STEPS} x 2 runs + "
          f"{t_mid + 1} samples-grid steps))", flush=True)
    check(launches == expected, "K2 launch count of the rollout CLI")
    if has_matplotlib():
        figures = {f"pred_t{t:04d}_u.png" for t in (0, t_mid, t_ref - 1)} | {
            "tke.png", "profiles_u.png", "probes_u.png", f"vorticity_t{t_ref - 1:04d}.png",
            f"samples_t{t_mid:04d}_u.png"}
        print(f"  figures written: {sorted(files & figures)}", flush=True)
        check(figures <= files, f"rollout CLI figures (missing {sorted(figures - files)})")
    check(saved == metrics and set(saved) == {"rollout_steps_per_sec", "steps", "n_samples",
                                              "rollout_steps_per_sec_seconds", "temperature",
                                              "backend", "devices"}, "rollout_metrics.json keys")
    mesh = rollout_cli.member_mesh(rollout_cli.visible_devices(dev), N_MEMBERS)
    print(f"  members split over {saved['devices']} device(s)", flush=True)
    check(saved["steps"] == CLI_STEPS and saved["n_samples"] == N_MEMBERS
          and saved["backend"] == dev.type and saved["devices"] == (mesh.size if mesh else 1)
          and all(abs(a - b) < 1e-6 for a, b in zip(saved["temperature"], CLI_TAU)),
          "rollout_metrics.json values")
    check(set(stats) == {"mean", "var"}, "rollout_stats.npz keys")
    for k, v in stats.items():
        check(v.shape == shape and bool(np.isfinite(v).all()), f"CLI {k} {v.shape} finite")
    check(bool((stats["var"] >= 0).all()), "CLI var >= 0")
    return {"launches": launches, "steps_per_sec": saved["rollout_steps_per_sec"]}


def cylinder_phase(dev, overrides=()) -> dict:
    """The ``cylinder-array`` case at its preset (96 x 96 HF, 4 members,
    100 steps, tau 0.85) from a seeded random init, perturbed as in
    "slice"; then K2 against its plain version at the case's three shapes
    and timed beside its bound."""
    import torch

    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.eval import make_ensemble_rollout
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, perturb_

    case = load_case("cylinder-array", parse_cli_overrides(overrides))
    cfg, n, steps = case.model, case.eval.n_samples, case.eval.rollout_steps
    model = TMGlow(cfg, device=dev, seed=0)
    perturb_(model, 1)
    gen = torch.Generator().manual_seed(2)
    lf = torch.randn(steps, *cfg.lf_shape, cfg.channels, generator=gen).to(dev)
    rollout = make_ensemble_rollout(model, n, case.eval.temperature, "stats")
    rollout(lf[:2], torch.Generator(dev).manual_seed(3))  # warm-up
    torch.cuda.synchronize()

    coupling_fused.launches = 0
    t0 = time.perf_counter()
    out = rollout(lf, torch.Generator(dev).manual_seed(4))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = coupling_fused.launches
    per_step = cfg.n_scales * cfg.n_flow_steps
    print(f"  rollout {n} members x {steps} steps at {cfg.hf_shape}: {elapsed:.3f} s, "
          f"{steps / elapsed:.3f} steps/s, K2 launches {launches} (expected {per_step} x "
          f"{steps})", flush=True)
    check(launches == per_step * steps, "K2 launch count of the cylinder rollout")
    for k in ("mean", "var"):
        check(tuple(out[k].shape) == (steps, *cfg.hf_shape, cfg.channels)
              and bool(torch.isfinite(out[k]).all()), f"cylinder {k} shape and finite")
    check(bool((out["var"] >= 0).all()), "cylinder var >= 0")
    k2 = kernel_phase(cfg, dev, b=n, b_train=None)
    return {"launches": launches, "steps_per_sec": steps / elapsed, "max_abs_err":
            k2["max_abs_err"], "shapes": k2["shapes"]}


def batched_phase(cfg, dev, b=4, n=16, steps=16) -> dict:
    """``make_batched_ensemble_rollout``, ``b`` trajectories x ``n``
    members as one batch: at f32 against a loop of single-trajectory
    rollouts with the same draws, then its steps/s at bf16 beside the
    loop's."""
    import dataclasses

    import torch

    from tpuflow_torch.eval import make_batched_ensemble_rollout, make_ensemble_rollout
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, latent_shapes, perturb_

    per_step = cfg.n_scales * cfg.n_flow_steps
    gen = torch.Generator(dev).manual_seed(9)
    lfs = torch.randn(b, steps, *cfg.lf_shape, cfg.channels, generator=gen, device=dev)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = TMGlow(cfg32, device=dev, seed=0)
    perturb_(model, 1)
    eps = [[[torch.randn(s, generator=gen, device=dev) for s in latent_shapes(cfg32, n)]
            for _ in range(steps)] for _ in range(b)]
    coupling_fused.launches = 0
    got = make_batched_ensemble_rollout(model, n, TAU)(lfs, eps=eps)
    torch.cuda.synchronize()
    check(coupling_fused.launches == per_step * steps, "K2 launch count of the f32 batched run")
    single = make_ensemble_rollout(model, n, TAU)
    worst = 0.0
    for i in range(b):
        want = single(lfs[i], eps=eps[i])
        for k in ("mean", "var"):
            err = (got[k][i] - want[k]).abs().max().item()
            scale = max(1.0, want[k].abs().max().item())
            worst = max(worst, err / scale)
            check(bool(torch.isfinite(got[k][i]).all()) and err <= SLICE_TOL * scale,
                  f"batched vs loop, trajectory {i} {k}")
    print(f"  f32 batched ({b} x {n} members x {steps} steps) vs loop: max err "
          f"{worst:.3e} x max(1, max |ref|) (tol {SLICE_TOL})", flush=True)
    del model, eps, got

    model = TMGlow(cfg, device=dev, seed=0)
    perturb_(model, 1)

    def gens():
        return [torch.Generator(dev).manual_seed(10 + i) for i in range(b)]

    roll = make_batched_ensemble_rollout(model, n, TAU)
    single = make_ensemble_rollout(model, n, TAU)
    roll(lfs[:, :2], gens())  # warm-up
    single(lfs[0, :2], gens()[0])
    torch.cuda.synchronize()
    coupling_fused.launches = 0
    t0 = time.perf_counter()
    out = roll(lfs, gens())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = coupling_fused.launches
    t0 = time.perf_counter()
    for i, g in enumerate(gens()):
        single(lfs[i], g)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    check(launches == per_step * steps, "K2 launch count of the bf16 batched run")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()), "bf16 batched stats finite")
    res = {"launches": launches, "max_rel_err_f32": worst, "steps_per_sec": steps / elapsed,
           "traj_steps_per_sec": b * steps / elapsed, "loop_traj_steps_per_sec": b * steps / loop_s}
    print(f"  bf16 batched {b} x {n} members x {steps} steps: {elapsed:.3f} s, "
          f"{res['steps_per_sec']:.3f} steps/s ({res['traj_steps_per_sec']:.3f} trajectory-steps/s; "
          f"the loop of {b} single rollouts {res['loop_traj_steps_per_sec']:.3f}); K2 launches "
          f"{launches} (expected {per_step} x {steps})", flush=True)
    return res


def redraw_phase(cfg, dev, steps: int) -> dict:
    """The overflow redraw: one member forced non-finite at each step's
    first draw (``sample_from_feats`` wrapped, as the CPU test does) is
    redrawn and the others are untouched; then 64-member rollouts with
    the redraw off and on, in turns, for its cost (no member fails)."""
    import torch

    from tpuflow_torch.eval import make_ensemble_rollout
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, latent_shapes, perturb_

    model = TMGlow(cfg, device=dev, seed=0)
    perturb_(model, 1)
    per_step = cfg.n_scales * cfg.n_flow_steps
    gen = torch.Generator(dev).manual_seed(11)
    lf = torch.randn(steps, *cfg.lf_shape, cfg.channels, generator=gen, device=dev)
    n, t_f = 8, 4
    eps, reps = ([[torch.randn(s, generator=gen, device=dev) for s in latent_shapes(cfg, n)]
                  for _ in range(t_f)] for _ in range(2))
    clean = make_ensemble_rollout(model, n, TAU, "fields")(lf[:t_f], eps=eps)
    orig = TMGlow.sample_from_feats

    def forced(self, feats, state, *, temperature=1.0, **kw):
        x, s = orig(self, feats, state, temperature=temperature, **kw)
        if float(torch.as_tensor(temperature).max()) > 0.7:  # not the 0.6 tau redraw
            x = x.clone()
            x[1] = float("inf")
        return x, s

    TMGlow.sample_from_feats = forced
    try:
        coupling_fused.launches = 0
        got = make_ensemble_rollout(model, n, TAU, "fields", overflow_redraw=True)(
            lf[:t_f], eps=eps, redraw_eps=reps)
        torch.cuda.synchronize()
        forced_launches = coupling_fused.launches
    finally:
        TMGlow.sample_from_feats = orig
    others = [i for i in range(n) if i != 1]
    err = (got[:, others] - clean[:, others]).abs().max().item()
    print(f"  forced overflow of member 1 ({n} members x {t_f} steps): redrawn finite "
          f"{bool(torch.isfinite(got[:, 1]).all())}, the others' max abs change {err:.3e}, K2 "
          f"launches {forced_launches} (expected {per_step} x {t_f} x 2)", flush=True)
    check(bool(torch.isfinite(got).all()) and not torch.allclose(got[:, 1], clean[:, 1])
          and err <= SLICE_TOL * max(1.0, clean[:, others].abs().max().item())
          and forced_launches == 2 * per_step * t_f, "overflow redraw of a forced member")

    rates = {False: [], True: []}
    rolls = {on: make_ensemble_rollout(model, N_MEMBERS, TAU, overflow_redraw=on)
             for on in (False, True)}
    rolls[True](lf[:2], torch.Generator(dev).manual_seed(12))  # warm-up
    torch.cuda.synchronize()
    launches = 0
    for on in (False, True, True, False):
        coupling_fused.launches = 0
        t0 = time.perf_counter()
        rolls[on](lf, torch.Generator(dev).manual_seed(13))
        torch.cuda.synchronize()
        rates[on].append(steps / (time.perf_counter() - t0))
        if on:
            launches = coupling_fused.launches
        check(coupling_fused.launches == per_step * steps, "no redraw fired in the timed runs")
    off, on = (sum(rates[k]) / 2 for k in (False, True))
    print(f"  {N_MEMBERS} members x {steps} steps, redraw off / on / on / off: "
          f"{rates[False][0]:.3f} / {rates[True][0]:.3f} / {rates[True][1]:.3f} / "
          f"{rates[False][1]:.3f} steps/s; the check costs {100 * (1 - on / off):.1f}% "
          "(mean of two each)", flush=True)
    return {"launches": launches, "forced_launches": forced_launches,
            "steps_per_sec_off": rates[False], "steps_per_sec_on": rates[True]}


def evaluate_phase(cfg, dev, overrides=()) -> dict:
    """The evaluator at the backward-step preset: K2 against its plain
    version at the batched rollout's B = traj_batch x n_samples, then
    ``python -m tpuflow_torch.cli.evaluate`` in-process on a checkpoint in
    the exporter's format holding the seeded init of "slice" (the "train"
    phase's checkpoint overflows), over the preset's synthetic test split
    (4 trajectories x 64 stored steps). K2 launches are counted over the
    evaluator's run; the stage seconds are printed. ``overrides``
    (key=value) shrink it for a rehearsal."""
    import json
    import tempfile

    import torch

    from tpuflow_torch.cli import evaluate as evaluate_cli
    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.eval.metrics import METRIC_KEYS, key_structure
    from tpuflow_torch.kernels import coupling_fused

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        args = [*overrides, f"train.checkpoint_dir={tmp}", f"eval.output_dir={tmp}/eval"]
        case = load_case("backward-step", parse_cli_overrides(args))
        e = case.eval
        if not overrides:
            check(e.n_samples == 64 and e.traj_batch == 4 and e.calibration_steps == 32
                  and e.ref_steps == 256, "the preset's eval section")
        b = min(e.traj_batch, case.data.n_test_traj) * e.n_samples
        t0 = time.perf_counter()
        worst = k2_parity(case.model, dev, b)
        print(f"  K2 vs plain at B = {b}: worst y err {worst:.3e} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        times = k2_times(case.model, dev, b)

        seeded_source(case, f"{tmp}/backward-step")
        seconds: dict = {}
        coupling_fused.launches = 0
        t0 = time.perf_counter()
        if has_matplotlib():
            metrics = evaluate_cli.main(["backward-step", *args, "--device", dev.type], seconds)
        else:
            print(f"  figures: not drawn on the card: matplotlib is not installed here, so "
                  f"{evaluate_cli.PROG} stops at its start; ran its compute half", flush=True)
            metrics, _ = evaluate_cli.evaluate(case, dev, seconds)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = coupling_fused.launches
        out = pathlib.Path(tmp) / "eval" / "backward-step"
        saved = json.loads((out / "eval_metrics.json").read_text())
        files = {p.name for p in out.iterdir()}

    per_step = case.model.n_scales * case.model.n_flow_steps
    T, n_traj = metrics["steps"], case.data.n_test_traj
    t_cal = min(e.calibration_steps, T)
    chunks = -(-n_traj // min(e.traj_batch, n_traj))
    # Calibration rollouts: trajectory 0, each other fit trajectory twice
    # (the fit, then the spectral chain's refit), each holdout one once.
    n_fit, n_hold = len(range(0, n_traj, 2)), len(range(1, n_traj, 2))
    cal_runs = 1 + 2 * (n_fit - 1) + n_hold
    expected = per_step * (T + chunks * T + cal_runs * t_cal)
    print(f"  {n_traj} trajectories x {e.n_samples} members, batches of {e.traj_batch} (K2 at "
          f"B = {b}), {T} steps, calibration {t_cal} steps, reference {metrics['ref_steps']} "
          f"steps: {elapsed:.2f} s; K2 launches {launches} (expected {per_step} x ({T} NLL + "
          f"{chunks} x {T} batched + {cal_runs} x {t_cal} calibration))", flush=True)
    print(f"  stage seconds ({SMI[0]}): " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()),
          flush=True)
    print(f"  test_bpd {metrics['test_bpd']:.4f}, field_rel_l2_mean "
          f"{metrics['field_rel_l2_mean']:.4f}, crps_mean {metrics['crps_mean']:.5f}, "
          f"spread_scale {metrics['spread_scale']:.4f}", flush=True)
    check(launches == expected, "K2 launch count of the evaluator")
    check(saved == metrics and key_structure(saved) == METRIC_KEYS,
          "eval_metrics.json has the JAX evaluator's 102 keys and nesting")

    bad = [k for k, v in saved.items() if not all(math.isfinite(x) for x in numbers(v))]
    check(not bad, f"every number of eval_metrics.json finite (not: {bad})")
    check(saved["backend"] == dev.type, f"backend {saved['backend']!r}")
    check(set(EVAL_ARTEFACTS) <= files, f"artefacts (have {sorted(files)})")
    if has_matplotlib():
        figures = {*EVAL_FIGURES, f"vorticity_t{T - 1:04d}.png"}
        print(f"  figures written: {sorted(files & figures)}", flush=True)
        check(figures <= files, f"evaluator figures (missing {sorted(figures - files)})")
    return {"launches": launches, "seconds": elapsed, "stage_seconds": seconds,
            "k2_parity_max_abs_err": worst, "k2_shapes": times}


def numbers(v) -> list:
    """Every number in a metrics value (nested dicts and lists; strings and
    booleans are not numbers)."""
    if isinstance(v, dict):
        return [x for u in v.values() for x in numbers(u)]
    if isinstance(v, list):
        return [x for u in v for x in numbers(u)]
    return [] if isinstance(v, (str, bool)) else [v]


def finetune_parity_phase(case, dev, b=4, m=6) -> dict:
    """One f32 fine-tune window of 2 timesteps at full width, B = ``b``,
    ``m`` members, every lambda nonzero: K2 forward at B and reverse at
    B x M under autograd, against the same window with the plain version
    swapped in for the kernel (same weights, data and draws). The loss
    to TRAIN_TOL_LOSS relative, every gradient and log_tau's to
    TRAIN_TOL_GRAD x max(1, max|g|)."""
    import dataclasses

    import torch

    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, init_lstm_state, perturb_
    from tpuflow_torch.train import finetune

    mcfg = dataclasses.replace(case.model, compute_dtype="float32")
    ds = load_dataset(dataclasses.replace(case.data, n_train_traj=b, train_steps=2), mcfg)
    lf, hf = torch.from_numpy(ds.lf).to(dev), torch.from_numpy(ds.hf).to(dev)
    spec = torch.stack([finetune.converged_log_spectra(hf[i]) for i in range(b)])
    model = TMGlow(mcfg, device=dev, seed=0)
    perturb_(model, 1)
    draws = finetune.window_draws(model, b, m, 2, torch.Generator(dev).manual_seed(21))
    loss_fn = finetune.make_finetune_loss(model, m)

    def window():
        model.zero_grad(set_to_none=True)
        lt = torch.log(torch.full((mcfg.n_scales,), 0.85, device=dev)).requires_grad_()
        loss, aux = loss_fn(lt, lf, hf, spec, init_lstm_state(mcfg, b, dev), 0.3, 0.02, 0.5,
                            draws)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        grads["log_tau"] = lt.grad.clone()
        return loss.item(), {k: aux[k].item() for k in ("bpd", "crps", "spec", "disp")}, grads

    before = coupling_fused.launches
    loss_k, aux_k, g_k = window()
    per_step = mcfg.n_scales * mcfg.n_flow_steps
    launched = coupling_fused.launches - before
    check(launched == 2 * 2 * per_step, f"kernel window launched K2 forward and reverse "
          f"({launched}, expected {2 * 2 * per_step})")
    kernel = coupling_fused.fused_coupling
    coupling_fused.fused_coupling = coupling_fused.fused_coupling_reference
    try:
        loss_p, aux_p, g_p = window()
    finally:
        coupling_fused.fused_coupling = kernel
    err_loss = abs(loss_k - loss_p) / max(1.0, abs(loss_p))
    errs = sorted(((g_k[n] - gp).abs().max().item() / max(1.0, gp.abs().max().item()), n)
                  for n, gp in g_p.items())
    worst = errs[-1][0]
    print(f"  f32 fine-tune window (B = {b}, {m} members, 2 steps), kernel vs plain: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel err {err_loss:.3e}, tol {TRAIN_TOL_LOSS}); terms "
          + ", ".join(f"{k} {aux_k[k]:.5f}/{aux_p[k]:.5f}" for k in aux_k)
          + f"; gradient err x max(1, max|g|) (tol {TRAIN_TOL_GRAD}), log_tau "
          f"{dict((n, e) for e, n in errs)['log_tau']:.3e}, worst of {len(errs)} tensors: "
          + ", ".join(f"{n} {e:.3e}" for e, n in errs[:-4:-1]), flush=True)
    check(all(math.isfinite(v) for v in (loss_k, loss_p)), "finite fine-tune loss")
    check(err_loss <= TRAIN_TOL_LOSS and worst <= TRAIN_TOL_GRAD,
          "f32 fine-tune window, kernel vs plain")
    return {"loss_rel_err": err_loss, "grad_rel_err": worst}


def remat_phase(case, dev, b=4, m=6) -> dict:
    """One fine-tune window (batch ``b``, ``m`` members, 8 steps) and one
    training window (batch 8, 8 steps) at full width, bf16 nets, remat
    off then on: peak device memory and seconds of each (a warm-up window
    first), and the losses, which must agree to TRAIN_TOL_LOSS relative."""
    import dataclasses

    import torch

    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.models import TMGlow, init_lstm_state, perturb_
    from tpuflow_torch.train import finetune, window_bpd_fn

    cfg, w = case.model, case.data.window
    ds = load_dataset(dataclasses.replace(case.data, n_train_traj=8, train_steps=w), cfg)
    lf, hf = torch.from_numpy(ds.lf).to(dev), torch.from_numpy(ds.hf).to(dev)
    spec = torch.stack([finetune.converged_log_spectra(hf[i]) for i in range(b)])
    model = TMGlow(cfg, device=dev, seed=0)
    perturb_(model, 1)

    def ft_window(remat):
        lt = torch.log(torch.full((cfg.n_scales,), 0.85, device=dev)).requires_grad_()
        loss, _ = finetune.make_finetune_loss(model, m, remat)(
            lt, lf[:b], hf[:b], spec, init_lstm_state(cfg, b, dev), 0.3, 0.02, 0.5,
            torch.Generator(dev).manual_seed(22))
        loss.backward()
        return loss

    def train_window(remat):
        loss, _ = window_bpd_fn(model, remat)(lf, hf, init_lstm_state(cfg, 8, dev))
        loss.backward()
        return loss

    out = {}
    for name, fn in (("finetune", ft_window), ("train", train_window)):
        fn(False)  # warm-up: cuDNN plans, the allocator
        res = {}
        for remat in (False, True):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            loss = fn(remat).item()
            torch.cuda.synchronize()
            res[remat] = dict(loss=loss, seconds=time.perf_counter() - t0,
                              peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                              base_gib=base / 2**30)
        off, on = res[False], res[True]
        rel = abs(on["loss"] - off["loss"]) / max(1.0, abs(off["loss"]))
        print(f"  {name} window (batch {b if name == 'finetune' else 8} x {w} steps"
              f"{f', {m} members' if name == 'finetune' else ''}, bf16): remat off "
              f"{off['seconds']:.3f} s, peak {off['peak_gib']:.3f} GiB; remat on "
              f"{on['seconds']:.3f} s, peak {on['peak_gib']:.3f} GiB (model and data "
              f"{off['base_gib']:.3f} GiB before the window); loss {off['loss']:.6f} / "
              f"{on['loss']:.6f} (rel diff {rel:.2e}, tol {TRAIN_TOL_LOSS}) [{SMI[0]}]",
              flush=True)
        check(math.isfinite(off["loss"]) and rel <= TRAIN_TOL_LOSS, f"{name} loss with remat")
        out[name] = {"off": off, "on": on}
    return out


def finetune_phase(case, dev, overrides=()) -> dict:
    """The fine-tune path: K2 held against its plain version (f32 window
    under autograd; bf16 alone at B = 4 and 24) and timed at the NLL
    forward's B = 4 and the members' B = 24; then ``python -m
    tpuflow_torch.tools.finetune`` in-process at the flagship's recipe
    (FT_ARGS) from an exporter-format file of the seeded init, K2
    launches counted over the run; its output served by the rollout CLI's
    compute half with the learned tau; remat off against on.
    ``overrides`` (key=value) shrink it for a rehearsal."""
    import csv
    import json
    import tempfile

    import numpy as np
    import torch

    from tpuflow_torch.cli import rollout as rollout_cli
    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.eval.loading import load_eval_bundle, resolve_temperature
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.tools import finetune as finetune_tool

    res: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ft_") as tmp:
        args = [*TRAIN_ARGS, *FT_ARGS, *overrides, f"train.checkpoint_dir={tmp}/src",
                f"finetune.checkpoint_dir={tmp}/ft"]
        cfg = load_case("backward-step", parse_cli_overrides(args))
        ft, d = cfg.finetune, cfg.data
        b, m = ft.batch_size, ft.n_members
        res.update(finetune_parity_phase(cfg, dev, b, m))
        worst = max(k2_parity(cfg.model, dev, bb) for bb in (b, b * m))
        print(f"  K2 vs plain at B = {b} and {b * m}: worst y err {worst:.3e}", flush=True)
        res["k2_parity_max_abs_err"] = worst
        res["k2_forward"] = k2_times(cfg.model, dev, b, reverse=False)
        res["k2_reverse"] = k2_times(cfg.model, dev, b * m)

        seeded_source(cfg, f"{tmp}/src/backward-step")
        per_step = cfg.model.n_scales * cfg.model.n_flow_steps
        n_batches = -(-d.n_train_traj // b)
        win_per_epoch = n_batches * (d.train_steps // d.window)
        n_windows = ft.epochs * win_per_epoch
        # Per timestep: the NLL forward at B and the reverse at B x M.
        expected = 2 * per_step * d.window * n_windows * (2 if ft.remat else 1)
        coupling_fused.launches = 0
        t0 = time.perf_counter()
        summary = finetune_tool.main(["backward-step", *args, "--device", dev.type])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = coupling_fused.launches
        with open(f"{tmp}/ft/backward-step_finetune_log.csv") as f:
            rows = list(csv.DictReader(f))
        epoch_s = [float(r["seconds"]) for r in rows]
        skipped = [int(float(r["skipped_windows"])) for r in rows]
        print(f"  {n_windows} windows ({ft.epochs} epochs x {n_batches} batches of {b} x "
              f"{d.train_steps // d.window} windows of {d.window} steps, {m} members, lambdas "
              f"{ft.lambda_crps} / {ft.lambda_spec} / {ft.lambda_disp}, scope "
              f"{ft.train_scope}, lr {ft.lr}): {elapsed:.2f} s with set-up; K2 launches "
              f"{launches} (expected 2 x {per_step} x {d.window} x {n_windows})", flush=True)
        print("  per epoch (loss, bpd, crps, spec, disp, grad norm, skipped windows, s): "
              + "; ".join(f"({r['loss']}, {r['bpd']}, {r['crps']}, {r['spec']}, {r['disp']}, "
                          f"{r['grad_norm']}, {r['skipped_windows']}, {r['seconds']})"
                          for r in rows), flush=True)
        rates = [win_per_epoch / s for s in epoch_s if s > 0]
        print(f"  fine-tune windows/s by the tool's epoch seconds: "
              f"{' / '.join(f'{r:.3f}' for r in rates)}; by the host clock over the whole run "
              f"(set-up included): {n_windows / elapsed:.3f} [{SMI[0]}]", flush=True)
        print(f"  skipped windows: {sum(skipped)} of {n_windows}; learned tau "
              f"{summary['learned_tau']}", flush=True)
        check(launches == expected, "K2 launch count of the fine-tune")
        check(len(rows) == ft.epochs and sum(skipped) < n_windows
              and all(math.isfinite(float(r["loss"])) for r in rows),
              "a finite loss in at least one fine-tune window")
        tau = summary["learned_tau"]
        check(len(tau) == 3 and all(0.0 < t <= 1.1 for t in tau), f"learned tau {tau}")

        serve = [*TRAIN_ARGS, *overrides, f"train.checkpoint_dir={tmp}/ft",
                 f"eval.rollout_steps={FT_SERVE_STEPS}", f"eval.n_samples={N_MEMBERS}",
                 f"eval.output_dir={tmp}/eval"]
        scfg = load_case("backward-step", parse_cli_overrides(serve))
        _, _, meta = load_eval_bundle(scfg, device=dev)
        deployed = resolve_temperature(scfg, meta, device=dev).tolist()
        coupling_fused.launches = 0
        metrics, _ = rollout_cli.rollout(scfg, dev)
        torch.cuda.synchronize()
        serve_launches = coupling_fused.launches
        out = pathlib.Path(tmp) / "eval" / "backward-step"
        with np.load(out / "rollout_stats.npz") as f:
            stats = {k: f[k] for k in f.files}
        saved = json.loads((out / "rollout_metrics.json").read_text())
        print(f"  served ({N_MEMBERS} members x {FT_SERVE_STEPS} steps, the rollout CLI's "
              f"compute half): tau {saved['temperature']}, "
              f"{saved['rollout_steps_per_sec']:.3f} steps/s, K2 launches {serve_launches}; "
              f"stats finite {all(bool(np.isfinite(v).all()) for v in stats.values())}",
              flush=True)
        check(all(abs(a - t) < 1e-6 for a, t in zip(deployed, tau))
              and all(abs(a - t) < 1e-6 for a, t in zip(saved["temperature"], tau)),
              "the rollout deploys the learned tau")
        check(set(stats) == {"mean", "var"} and all(bool(np.isfinite(v).all())
                                                    for v in stats.values()),
              "finite stats of the fine-tuned checkpoint")
    res["remat"] = remat_phase(cfg, dev, b, m)
    res.update(launches=launches, windows=n_windows, seconds=elapsed, epoch_seconds=epoch_s,
               windows_per_sec=rates, windows_per_sec_host=n_windows / elapsed,
               skipped_windows=sum(skipped), learned_tau=tau, serve_launches=serve_launches)
    return res


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_reference():
    """(the "train" phase's config, its model at f32, and the first window
    (lf, hf) of its first trajectory batch, NumPy on the host)."""
    import dataclasses

    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.data import load_dataset

    tcfg = load_case("backward-step", parse_cli_overrides(TRAIN_ARGS))
    mcfg = dataclasses.replace(tcfg.model, compute_dtype="float32")
    ds = load_dataset(tcfg.data, mcfg)
    idx = next(ds.batch_indices(tcfg.data.seed, tcfg.data.batch_size))
    w = tcfg.data.window
    return tcfg, mcfg, ds.lf[idx, :w], ds.hf[idx, :w]


def dp_worker(rank: int, port: int, workdir: str) -> int:
    """One rank of the "data parallel" phase, a child process: joins a gloo
    group of two on the one card, loads the parent's f32 model, and runs
    DP_WINDOWS windows of ``train.train_step`` on its rows of the batch (K2
    launches counted over them); the first window's loss and averaged
    gradients, the timings and the all-reduce's time go to
    ``workdir/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from tpuflow_torch.device import resolve_device
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, init_lstm_state
    from tpuflow_torch.train import make_optimizer, mesh as mesh_lib, train_step

    dev = resolve_device("cuda")
    tcfg, mcfg, lf, hf = dp_reference()
    # gloo, on CUDA tensors: NCCL refuses two ranks on one GPU.
    mesh_lib.initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
    try:
        mesh = mesh_lib.make_mesh(-1, 1)
        rows = mesh_lib.data_sharding(mesh, lf.shape[0])
        model = TMGlow(mcfg, device=dev)
        model.load_state_dict(torch.load(f"{workdir}/model.pt", map_location=dev))
        opt, sched = make_optimizer(model.parameters(), tcfg.train.lr, tcfg.train.lr_decay)
        lf_r, hf_r = (torch.from_numpy(a[rows]).to(dev) for a in (lf, hf))
        out: dict = {"rows": [rows.start, rows.stop], "seconds": []}
        coupling_fused.launches = 0
        for i in range(DP_WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = train_step(model, opt, sched, tcfg.train.grad_clip, lf_r, hf_r,
                              init_lstm_state(mcfg, lf_r.shape[0], dev))
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            if i == 0:
                out["bpd"], out["grad_norm"] = m["bpd"].item(), m["grad_norm"].item()
                out["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        out["launches"] = coupling_fused.launches
        grads = [p.grad for p in model.parameters()]
        out["allreduce_mbytes"] = sum(g.numel() for g in grads) * 4 / 1e6
        out["allreduce_ms"] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh_lib.all_reduce_mean_(grads)
            torch.cuda.synchronize()
            out["allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
        torch.save(out, f"{workdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def data_parallel_phase(dev) -> dict:
    """Data parallelism at full width, f32, one window of batch 8 x 8 steps:
    two ranks as child processes on the one card over gloo (NCCL refuses
    two ranks on one GPU), each on 4 rows, held against one process on the
    full batch, both through K2; then an NCCL all-reduce of the one
    process's gradients in a world of one, and that world (the backend of
    a multi-GPU host) through the training CLI, one epoch of the "train"
    phase's fixture. Windows/s of each."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from tpuflow_torch.cli.train import main as train_main
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, init_lstm_state, perturb_
    from tpuflow_torch.train import make_optimizer, mesh as mesh_lib, train_step

    tcfg, mcfg, lf, hf = dp_reference()
    per_window = mcfg.n_scales * mcfg.n_flow_steps * tcfg.data.window
    model = TMGlow(mcfg, device=dev, seed=0)
    lf_d, hf_d = torch.from_numpy(lf).to(dev), torch.from_numpy(hf).to(dev)
    model.data_init(hf_d[:, 0], lf_d[:, 0], init_lstm_state(mcfg, lf.shape[0], dev))
    perturb_(model, 6)  # non-zero coupling heads and priors
    res: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        torch.save(model.state_dict(), f"{tmp}/model.pt")
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--dp-rank", str(r),
             "--dp-port", str(port), "--dp-dir", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(f"  rank {r} exited {p.returncode}:\n{log[-6000:]}", flush=True)
            check(p.returncode == 0, f"data-parallel rank {r}")
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(2)]

    # One process on the full batch: the held window, then the timed ones.
    opt, sched = make_optimizer(model.parameters(), tcfg.train.lr, tcfg.train.lr_decay)
    one_s = []
    coupling_fused.launches = 0
    for i in range(DP_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = train_step(model, opt, sched, tcfg.train.grad_clip, lf_d, hf_d,
                          init_lstm_state(mcfg, lf.shape[0], dev))
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t0)
        if i == 0:
            loss = m["bpd"].item()
            want = {n: p.grad.cpu() for n, p in model.named_parameters()}
    check(coupling_fused.launches == DP_WINDOWS * per_window, "K2 launches, one process")
    for r, got in enumerate(ranks):
        err_loss = abs(got["bpd"] - loss) / max(1.0, abs(loss))
        errs = sorted(((got["grads"][n] - g).abs().max().item() / max(1.0, g.abs().max().item()),
                       n) for n, g in want.items())
        print(f"  rank {r} (rows {got['rows']}): loss {got['bpd']:.6f} vs one process "
              f"{loss:.6f} (rel err {err_loss:.3e}, tol {DP_TOL_LOSS}); gradient err x max(1, "
              f"max|g|) (tol {DP_TOL_GRAD}), worst of {len(errs)}: "
              + ", ".join(f"{n} {e:.3e}" for e, n in errs[:-4:-1])
              + f"; K2 launches {got['launches']} (expected {DP_WINDOWS} x {per_window})",
              flush=True)
        check(err_loss <= DP_TOL_LOSS and errs[-1][0] <= DP_TOL_GRAD,
              f"rank {r}'s window against one process on the full batch")
        check(got["launches"] == DP_WINDOWS * per_window, f"K2 launches of rank {r}")
    check(all(torch.equal(ranks[0]["grads"][n], ranks[1]["grads"][n]) for n in want),
          "both ranks hold the same averaged gradients")
    rank_s = [max(a, b) for a, b in zip(ranks[0]["seconds"], ranks[1]["seconds"])]
    ar = sorted(ranks[0]["allreduce_ms"] + ranks[1]["allreduce_ms"])
    res.update(loss_rel_err=err_loss, grad_rel_err=errs[-1][0],
               one_process_windows_per_sec=1 / min(one_s[1:]),
               two_ranks_windows_per_sec=1 / min(rank_s[1:]),
               allreduce_ms=ar[len(ar) // 2], allreduce_mbytes=ranks[0]["allreduce_mbytes"],
               launches=ranks[0]["launches"] + ranks[1]["launches"])
    print(f"  f32 window batch 8 x 8 steps, windows/s (best of {DP_WINDOWS - 1} after the held "
          f"one): one process {res['one_process_windows_per_sec']:.3f}, two ranks on one card "
          f"{res['two_ranks_windows_per_sec']:.3f} (each on 4 rows; two processes sharing one "
          f"card are no speed-up); gloo all-reduce of {res['allreduce_mbytes']:.1f} MB of "
          f"gradients {res['allreduce_ms']:.2f} ms (median of 6) [{SMI[0]}]", flush=True)

    # An NCCL collective on the card: NCCL refuses two ranks on one GPU, and
    # a world of one averages nothing (all_reduce_mean_ returns at once), so
    # the one process's flattened gradients go through dist.all_reduce in
    # an NCCL world of one, where the sum over one rank is its input.
    mesh_lib.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
        sent, nccl_ms = flat.clone(), []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(flat)
            torch.cuda.synchronize()
            nccl_ms.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(flat, sent), "NCCL all-reduce over one rank returns its input")
    finally:
        dist.destroy_process_group()
    res["nccl_allreduce_ms"] = sorted(nccl_ms)[1]
    print(f"  NCCL all-reduce of the same {res['allreduce_mbytes']:.1f} MB in a world of one: "
          f"returned its input; {res['nccl_allreduce_ms']:.3f} ms (median of 3; no transfer "
          f"between cards) [{SMI[0]}]", flush=True)
    del model, opt, flat, sent

    # One NCCL world through the training CLI, as torchrun launches it, for
    # one epoch: the "train" phase already trains two.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": "1",
               "RANK": "0", "LOCAL_RANK": "0"}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        coupling_fused.launches = 0
        try:
            final = train_main(["backward-step", *TRAIN_ARGS, f"train.checkpoint_dir={tmp}",
                                "train.epochs=1", "--device", dev.type])
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        torch.cuda.synchronize()
        nccl_launches = coupling_fused.launches
    d = tcfg.data
    n_windows = (d.n_train_traj // d.batch_size) * (d.train_steps // d.window)
    expected = tcfg.model.n_scales * tcfg.model.n_flow_steps * (1 + d.window * n_windows)
    print(f"  NCCL world of 1 through the CLI: epoch {final['epoch']}, bpd "
          f"{final['mean_bpd']:.4f}, {final['windows_per_sec']:.3f} windows/s in epoch 1 "
          f"(bf16, batch 8); K2 launches {nccl_launches} (expected {expected}) [{SMI[0]}]",
          flush=True)
    check(final["epoch"] == 1 and math.isfinite(final["mean_bpd"])
          and nccl_launches == expected, "NCCL training through the CLI")
    res.update(nccl_windows_per_sec=final["windows_per_sec"], nccl_launches=nccl_launches)
    return res


def split_phase(cfg, dev, steps: int, n=N_MEMBERS) -> dict:
    """The member split: K2 held against its plain version at the chunks'
    batch sizes; ``n`` members as two chunks of n/2 on a mesh of [card,
    card] (the second on a replica), against the flat rollout on the same
    generator, bf16 at ``steps`` steps and f32 at 2; then both timed,
    flat / split / split / flat, with the redraw off."""
    import dataclasses

    import torch

    from tpuflow_torch.eval import make_ensemble_rollout
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, perturb_
    from tpuflow_torch.train import make_mesh

    per_step = cfg.n_scales * cfg.n_flow_steps
    # K2 at each chunk's batch against its plain version: n/2 here, n/4
    # and n/8 where the rollout CLI splits over 4 or 8 cards.
    res: dict = {"max_abs_err": max(k2_parity(cfg, dev, b) for b in (n // 2, n // 4, n // 8))}
    gen = torch.Generator().manual_seed(14)
    lf = torch.randn(steps, *cfg.lf_shape, cfg.channels, generator=gen).to(dev)
    for dtype, t in (("float32", 2), ("bfloat16", steps)):
        model = TMGlow(dataclasses.replace(cfg, compute_dtype=dtype), device=dev, seed=0)
        perturb_(model, 1)
        mesh = make_mesh(1, 2, devices=[model.device, model.device])
        flat = make_ensemble_rollout(model, n, TAU)
        split = make_ensemble_rollout(model, n, TAU, mesh=mesh)
        coupling_fused.launches = 0
        got = split(lf[:t], torch.Generator(dev).manual_seed(15))
        torch.cuda.synchronize()
        launches = coupling_fused.launches
        want = flat(lf[:t], torch.Generator(dev).manual_seed(15))
        errs = {k: (got[k] - want[k]).abs().max().item() / max(1.0, want[k].abs().max().item())
                for k in want}
        print(f"  {dtype} {n} members x {t} steps, split in 2 chunks vs flat on one generator: "
              f"err x max(1, max |ref|) mean {errs['mean']:.3e}, var {errs['var']:.3e} (tol "
              f"{SPLIT_TOL[dtype]}); K2 launches {launches} (expected 2 x {per_step} x {t})",
              flush=True)
        check(all(bool(torch.isfinite(v).all()) for v in got.values())
              and max(errs.values()) <= SPLIT_TOL[dtype], f"{dtype} split vs flat")
        check(launches == 2 * per_step * t, f"K2 launches of the {dtype} split")
        res[f"max_rel_err_{dtype}"] = max(errs.values())
    res["launches"] = launches
    rates = {"flat": [], "split": []}
    for name in ("flat", "split", "split", "flat"):
        roll = flat if name == "flat" else split
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        roll(lf, torch.Generator(dev).manual_seed(16))
        torch.cuda.synchronize()
        rates[name].append(steps / (time.perf_counter() - t0))
    print(f"  bf16 {n} x {steps}, steps/s flat / split / split / flat: {rates['flat'][0]:.3f} / "
          f"{rates['split'][0]:.3f} / {rates['split'][1]:.3f} / {rates['flat'][1]:.3f} (one host "
          f"thread drives both chunks on one card: the split launches twice per step) "
          f"[{SMI[0]}]", flush=True)
    res.update(steps_per_sec_flat=rates["flat"], steps_per_sec_split=rates["split"])
    return res


def stream_phase(dev, overrides=()) -> dict:
    """The data tier on the card's host: the "train" phase's fixture written
    to .tpf (and .h5 where h5py is installed), the store's first batch held
    to the RAM loader's, then one epoch through the training CLI with
    ``data.loader=stream``, and one epoch of the Trainer streamed beside
    one from RAM on the same seed and constants (epoch 1's mean bpd within
    STREAM_TOL_BPD); windows/s side by side."""
    import csv
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tpuflow_torch.cli.train import main as train_main
    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.data import NormStats, TrajectoryDataset, generate_case, load_archive
    from tpuflow_torch.data import save_archive
    from tpuflow_torch.data.tpf import StreamingTrajectoryDataset, TPFStore, save_tpf
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.train import Trainer
    from tpuflow_torch.utils.logging import MetricsLogger

    tcfg = load_case("backward-step", parse_cli_overrides([*TRAIN_ARGS, *overrides]))
    d, mc = tcfg.data, tcfg.model
    lf, hf = generate_case(d.case, d.n_train_traj, d.train_steps, mc.hf_shape, mc.lf_shape,
                           seed=d.seed, fixture_version=d.fixture_version)
    gxx = shutil.which("g++")
    res: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        save_tpf(f"{tmp}/backward-step_train.tpf", lf, hf)
        archive = "h5" if importlib.util.find_spec("h5py") else "npz"
        save_archive(f"{tmp}/backward-step_train.{archive}", lf, hf)
        back = load_archive(f"{tmp}/backward-step_train.{archive}")
        check(all(np.array_equal(a, b) for a, b in zip(back, (lf, hf))), f".{archive} roundtrip")
        if archive == "h5":
            print("  .h5 archive written and read back bit-equal", flush=True)
        else:
            print("  .h5 not checked: h5py is not installed here (.npz written and read back "
                  "instead)", flush=True)
        store = TPFStore(f"{tmp}/backward-step_train.tpf")
        native = store.native
        print(f"  TPFStore.native {native}; g++ {gxx or 'not found'}", flush=True)
        check(store.native or gxx is None, "the native loader builds where g++ is present")
        ram = TrajectoryDataset(lf, hf)
        idx = next(ram.batch_indices(d.seed, d.batch_size))
        raw = [store.read_batch(w, idx, 0, d.train_steps) for w in ("lf", "hf")]
        check(np.array_equal(raw[0], lf[idx]) and np.array_equal(raw[1], hf[idx]),
              "the store's raw first batch bit-equal to the arrays")
        # Stds that are powers of two make the fused normalization exact.
        pow2 = NormStats(lf_mean=ram.norm.lf_mean, lf_std=np.exp2(np.round(np.log2(
            ram.norm.lf_std))).astype(np.float32), hf_mean=ram.norm.hf_mean,
            hf_std=np.exp2(np.round(np.log2(ram.norm.hf_std))).astype(np.float32))
        got = next(StreamingTrajectoryDataset(store, norm=pow2).traj_batches(d.seed, d.batch_size))
        want = next(TrajectoryDataset(lf, hf, pow2).traj_batches(d.seed, d.batch_size))
        check(all(np.array_equal(a, b) for a, b in zip(got, want)),
              "the streamed first batch bit-equal to the RAM loader's")
        got = next(StreamingTrajectoryDataset(store, norm=ram.norm).traj_batches(
            d.seed, d.batch_size))
        want = next(ram.traj_batches(d.seed, d.batch_size))
        norm_err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        on_card = [torch.from_numpy(a).to(dev) for a in got]
        check(all(torch.equal(c.cpu(), torch.from_numpy(a)) for c, a in zip(on_card, got)),
              "the streamed batch uploaded to the card")
        print(f"  first batch (ids {idx.tolist()}): raw and power-of-two-normalized gathers "
              f"bit-equal to RAM; with the fixture's constants max abs err {norm_err:.3e} "
              f"(tol {STREAM_TOL_NORM})",
              flush=True)
        check(norm_err <= STREAM_TOL_NORM, "the streamed first batch on the store's constants")
        store.close()

        # Streamed training through the CLI on the store's own constants,
        # one epoch, K2 launches counted. Then one epoch each of the Trainer on the
        # stream and on RAM (device-resident) with the power-of-two
        # constants, whose inputs are bit-equal: on the store's own
        # constants RAM's (x - mean) / std and the store's fused product
        # round an input an ulp apart, and the bf16 nets carry that to
        # ~3e-5 of epoch 1's bpd (PERF.md §6).
        coupling_fused.launches = 0
        final = train_main(["backward-step", *TRAIN_ARGS, *overrides, "data.synthetic=false",
                            "data.loader=stream", f"data.data_dir={tmp}",
                            f"train.checkpoint_dir={tmp}/cli", "train.epochs=1",
                            "--device", dev.type])
        torch.cuda.synchronize()
        cli = dict(final=final, launches=coupling_fused.launches)
        runs = {}
        for name in ("stream", "ram"):
            store = TPFStore(f"{tmp}/backward-step_train.tpf")
            ds = (StreamingTrajectoryDataset(store, norm=pow2) if name == "stream"
                  else TrajectoryDataset(lf, hf, pow2))
            rcfg = load_case("backward-step", parse_cli_overrides(
                [*TRAIN_ARGS, *overrides, f"train.checkpoint_dir={tmp}/{name}", "train.epochs=1"]))
            logger = MetricsLogger(f"{tmp}/{name}/backward-step/train_log.csv", quiet=True)
            trainer = Trainer(rcfg, dataset=ds, logger=logger, device=dev)
            check(trainer._resident == (name == "ram"), f"{name} residency")
            trainer.init_or_resume()
            last = trainer.run()
            logger.close()
            store.close()
            with open(f"{tmp}/{name}/backward-step/train_log.csv") as f:
                bpds = [float(r["bpd"]) for r in csv.DictReader(f)]
            runs[name] = dict(final=last, epoch1_bpd=sum(bpds) / len(bpds))
    s, r = runs["stream"], runs["ram"]
    n_windows = (d.n_train_traj // d.batch_size) * (d.train_steps // d.window)
    per_step = mc.n_scales * mc.n_flow_steps
    expected = per_step * (1 + d.window * n_windows)
    rel = abs(s["epoch1_bpd"] - r["epoch1_bpd"]) / abs(r["epoch1_bpd"])
    print(f"  CLI, data.loader=stream: epoch {cli['final']['epoch']}, "
          f"{cli['final']['windows_per_sec']:.3f} windows/s in epoch 1 (bf16, batch "
          f"8) [{SMI[0]}]; K2 launches {cli['launches']} (expected {expected})", flush=True)
    print(f"  Trainer, epoch 1 on the power-of-two constants: mean bpd stream "
          f"{s['epoch1_bpd']:.7f} vs RAM {r['epoch1_bpd']:.7f} (rel err {rel:.3e}, tol "
          f"{STREAM_TOL_BPD}); windows/s stream {s['final']['windows_per_sec']:.3f} / RAM "
          f"(device-resident) {r['final']['windows_per_sec']:.3f} [{SMI[0]}]", flush=True)
    check(rel <= STREAM_TOL_BPD, "streamed epoch 1 against RAM")
    check(cli["launches"] == expected and cli["final"]["epoch"] == 1
          and math.isfinite(cli["final"]["mean_bpd"]),
          "K2 launches of streamed training through the CLI")
    res.update(native=native, h5=archive == "h5", norm_max_abs_err=norm_err,
               epoch1_bpd_rel_err=rel, launches=cli["launches"],
               cli_windows_per_sec=cli["final"]["windows_per_sec"],
               stream_windows_per_sec=s["final"]["windows_per_sec"],
               ram_windows_per_sec=r["final"]["windows_per_sec"])
    return res

# The "serve" phase: the served stats against the eager rollout on the same
# seeded generator, relative to max(1, max |ref|). f32: the exported step
# runs the eager step's kernels, so only a reordered reduction could move
# a value; bf16: the conditioning's cuDNN convs may pick another
# algorithm in another program and round a feature one ulp apart.
SERVE_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
SERVE_PAIRS = 3  # served / eager timings, interleaved (a rate spreads in a call)


def serve_phase(case, dev, steps: int) -> dict:
    """The serving artifact (``tools/export_rollout.py``, ``tools/artifact.py``,
    ``tools/serve.py``) at full backward-step width, 64 members, the seeded
    init of "slice": exported on the card at f32 and bf16 (seconds and
    bytes), loaded (seconds), its stats held against ``make_ensemble_rollout``
    on a generator seeded the same way, denormalized, with K2 counted (24
    launches per served step); at bf16 the served and eager steps/s timed in
    SERVE_PAIRS interleaved pairs, and one HTTP round trip on localhost
    (bytes against Content-Length, arrays against the direct call)."""
    import dataclasses
    import io
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from tpuflow_torch.data import NormStats, generate_case
    from tpuflow_torch.eval import make_ensemble_rollout
    from tpuflow_torch.kernels import coupling_fused, ops
    from tpuflow_torch.models import TMGlow, perturb_
    from tpuflow_torch.models.tmglow import scale_shapes
    from tpuflow_torch.tools.artifact import load_artifact, write_artifact
    from tpuflow_torch.tools.export_rollout import build_exported, sidecar
    from tpuflow_torch.tools.serve import RolloutServer, make_http_server

    mc = case.model
    # The registered operator launches the kernel the wrapper launches:
    # bit-equal at the rollout's shapes, both directions and net dtypes.
    gen, c = torch.Generator().manual_seed(6), mc.channels
    for l, (h, w) in enumerate(scale_shapes(mc)):
        c = 4 * c if l == 0 else 2 * c
        for dtype in (torch.float32, torch.bfloat16):
            xs = random_coupling(N_MEMBERS, h, w, c // 2, mc.coupling_width, mc.growth_rate,
                                 mc.coupling_layers, dtype, 1, gen, dev)
            for reverse in (False, True):
                a = ops.fused_coupling(*xs, reverse=reverse)
                b = coupling_fused.fused_coupling(*xs, reverse=reverse)
                check(all(torch.equal(u, v) for u, v in zip(a, b)),
                      f"the operator against the wrapper at scale {l} {dtype} reverse={reverse}")
    print(f"  tpuflow_torch::fused_coupling bit-equal to the wrapper at the {mc.n_scales} "
          "scales' shapes, f32 and bf16, both directions", flush=True)

    cfg = dataclasses.replace(case, eval=dataclasses.replace(
        case.eval, rollout_steps=steps, n_samples=N_MEMBERS))
    norm = NormStats.from_data(*generate_case("backward-step", 2, 4, mc.hf_shape, mc.lf_shape))
    lf = torch.randn(steps, *mc.lf_shape, mc.channels,
                     generator=torch.Generator().manual_seed(2)).to(dev)
    tau = torch.full((mc.n_scales,), TAU, device=dev)
    hf_std, hf_mean = (torch.from_numpy(a).to(dev) for a in (norm.hf_std, norm.hf_mean))
    per_step = mc.n_scales * mc.n_flow_steps
    res: dict = {"launches": 0}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        for dtype in ("float32", "bfloat16"):
            cfg_d = dataclasses.replace(cfg, model=dataclasses.replace(mc, compute_dtype=dtype))
            model = TMGlow(cfg_d.model, device=dev, seed=0)
            perturb_(model, 1)
            path = pathlib.Path(tmp) / dtype / "rollout.torchexport"
            t0 = time.perf_counter()
            exported = build_exported(cfg_d, model, norm)
            nbytes = write_artifact(path, *exported)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            served = load_artifact(path)
            load_s = time.perf_counter() - t0
            served(lf, 3, tau)  # warm-up: cuDNN plans, the allocator
            torch.cuda.synchronize()

            coupling_fused.launches = 0
            got = served(lf, 4, tau)
            torch.cuda.synchronize()
            launches = coupling_fused.launches
            res["launches"] += launches
            ref = make_ensemble_rollout(model, N_MEMBERS, tau, "stats")(
                lf, torch.Generator(dev).manual_seed(4))
            want = {"mean": ref["mean"] * hf_std + hf_mean, "var": ref["var"] * hf_std**2}
            err = max((got[k] - want[k]).abs().max().item()
                      / max(1.0, want[k].abs().max().item()) for k in want)
            print(f"  {dtype}: exported in {export_s:.2f} s ({nbytes / 1e6:.1f} MB), loaded in "
                  f"{load_s:.2f} s; {N_MEMBERS} members x {steps} steps served, K2 launches "
                  f"{launches} (expected {per_step} x {steps}); served vs eager stats "
                  f"{err:.3e} of max(1, max |ref|) (tol {SERVE_TOL[dtype]})", flush=True)
            check(launches == per_step * steps, f"K2 launch count of the served {dtype} rollout")
            check(all(bool(torch.isfinite(got[k]).all()) and tuple(got[k].shape)
                      == (steps, *mc.hf_shape, mc.channels) for k in got), f"served {dtype} stats")
            check(err <= SERVE_TOL[dtype], f"served {dtype} stats against the eager rollout")
            res[dtype] = dict(export_s=export_s, load_s=load_s, bytes=nbytes, max_rel_err=err)
        # bf16, the preset's nets: served against eager steps/s, interleaved.
        eager = make_ensemble_rollout(model, N_MEMBERS, tau, "stats")
        rates: dict = {"served": [], "eager": []}
        for i in range(SERVE_PAIRS):
            runs = (("served", lambda: served(lf, 10 + i, tau)),
                    ("eager", lambda: eager(lf, torch.Generator(dev).manual_seed(10 + i))))
            for name, run in runs:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                rates[name].append(steps / (time.perf_counter() - t0))
        ratio = sorted(s / e for s, e in zip(rates["served"], rates["eager"]))[SERVE_PAIRS // 2]
        print(f"  bf16 steps/s, {SERVE_PAIRS} interleaved pairs: served "
              f"{', '.join(f'{r:.3f}' for r in rates['served'])}; eager "
              f"{', '.join(f'{r:.3f}' for r in rates['eager'])}; median served / eager "
              f"{ratio:.3f} [{SMI[0]}]", flush=True)
        res.update(served_steps_per_sec=rates["served"], eager_steps_per_sec=rates["eager"],
                   served_over_eager=ratio)

        # One HTTP round trip: the normalized input, so the server's program
        # sees the direct call's input and generator seed.
        path.with_suffix(".meta.json").write_text(json.dumps(sidecar(cfg_d, norm, TAU,
                                                                     exported[2])))
        server = RolloutServer(path, device=dev)
        httpd = make_http_server(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            buf = io.BytesIO()
            np.savez(buf, lf=lf.cpu().numpy())
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/rollout?seed=4&normalized=1",
                data=buf.getvalue(), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                body, length = resp.read(), int(resp.headers["Content-Length"])
            http_s = time.perf_counter() - t0
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join()
        with np.load(io.BytesIO(body)) as out:
            http_err = max(float(np.abs(out[k] - got[k].cpu().numpy()).max()) for k in got)
        print(f"  HTTP POST /rollout on localhost: {http_s:.3f} s, {len(body)} bytes "
              f"(Content-Length {length}); against the direct call {http_err:.3e}", flush=True)
        check(len(body) == length, "HTTP response bytes against Content-Length")
        check(http_err <= SERVE_TOL["bfloat16"], "HTTP response against the direct call")
        res.update(http_s=http_s, http_bytes=len(body))
    return res


def tools_phase(case, dev) -> dict:
    """The rollout tools at full width, each with the K2 count set to 0 just
    before it and read just after: ``sweep_members`` at 32 and 64 members;
    ``probe_width`` at coupling width 64 and 128, after K2 is held against
    its plain version at width 128 (new ca and width); on an exporter-format
    checkpoint of the seeded init, ``probe_tau_stability`` on one tau and one
    seed, ``sweep_temperature.sweep`` at two taus and ``probe_spectrum`` on an
    8-step window; then ``doctor``, every check passing, the device's
    included. Cut: 8 rollout steps (4 for the width probe), 2 test
    trajectories of 8 steps, 4 calibration and 16 reference steps."""
    import dataclasses
    import tempfile

    import torch

    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.tools import (
        doctor,
        probe_spectrum,
        probe_tau_stability,
        probe_width,
        sweep_members,
        sweep_temperature,
    )

    per_step = case.model.n_scales * case.model.n_flow_steps
    res: dict = {"launches": 0, "launches_by_tool": {}, "seconds": {}}

    def run(name, fn, expected_steps, data_inits=0):
        """``fn()`` with K2 counted: ``expected_steps`` rollout steps, and
        ``data_inits`` forwards of the model (ActNorm's data init)."""
        coupling_fused.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["seconds"][name] = time.perf_counter() - t0
        n = coupling_fused.launches
        res["launches_by_tool"][name] = n
        res["launches"] += n
        print(f"  {name}: {res['seconds'][name]:.2f} s, K2 launches {n} (expected {per_step} x "
              f"({expected_steps} steps + {data_inits} data-init forwards))", flush=True)
        check(n == per_step * (expected_steps + data_inits), f"K2 launch count of {name}")
        return out

    # 8 steps: a warm-up and 3 timed rollouts per width.
    rows = run("sweep_members", lambda: sweep_members.sweep(case, (32, 64), 8, 3, dev), 2 * 4 * 8,
               data_inits=1)
    print(f"  members sweep: {rows} [{SMI[0]}]", flush=True)
    check([r["members"] for r in rows] == [32, 64] and all(r["steps_per_sec"] > 0 for r in rows),
          "sweep_members rows")
    res["members_sweep"] = rows

    res["k2_width128_max_abs_err"] = k2_parity(dataclasses.replace(case.model, coupling_width=128),
                                               dev, N_MEMBERS)
    rows = run("probe_width", lambda: [probe_width.probe("backward-step", w, 4, N_MEMBERS, tau=TAU,
                                                         device=dev) for w in (64, 128)], 2 * 4 * 4,
               data_inits=2)
    print(f"  width probe: {rows} [{SMI[0]}]", flush=True)
    check([r["coupling_width"] for r in rows] == [64, 128] and rows[1]["n_params"] > rows[0][
        "n_params"] and all(r["backend"] == "cuda" for r in rows), "probe_width rows")
    res["width_probe"] = rows

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        cfg = load_case("backward-step", parse_cli_overrides([
            "data.n_train_traj=2", "data.n_test_traj=2", "data.train_steps=8",
            "eval.rollout_steps=8", "eval.calibration_steps=4", "eval.ref_steps=16",
            f"train.checkpoint_dir={tmp}"]))
        seeded_source(cfg, f"{tmp}/backward-step")
        rows = run("probe_tau_stability",
                   lambda: probe_tau_stability.probe(cfg, [TAU], cfg.model.z_clip, 1, dev), 8)
        check(len(rows) == 1 and len(rows[0]["max_abs_head"]) == 4, "probe_tau_stability row")
        # Per tau: 2 trajectories x 8 stats steps and 2 x 4 fields steps.
        rows = run("sweep_temperature",
                   lambda: sweep_temperature.sweep(cfg, (0.5, TAU), dev), 2 * (2 * 8 + 2 * 4))
        print(f"  temperature sweep: {rows}", flush=True)
        check([r["temperature"] for r in rows] == [0.5, TAU] and all(
            math.isfinite(r[k]) for r in rows for k in ("field_rel_l2", "tke_rel_l2",
                                                        "gaussian_crps", "ensemble_std")),
              "sweep_temperature rows")
        grid = probe_spectrum.tau_grid(cfg.eval.temperature, cfg.model.n_scales)
        rows = run("probe_spectrum", lambda: probe_spectrum.run_probe(cfg, 8, 8, dev),
                   len(grid) * 8)
        check([r["setting"] for r in rows] == [g[0] for g in grid], "probe_spectrum rows")

    t0 = time.perf_counter()
    doc = doctor.run_checks()
    res["seconds"]["doctor"] = time.perf_counter() - t0
    for name, c in doc["checks"].items():
        print(f"  doctor {name}: {'PASS' if c['ok'] else 'FAIL'} {c['detail']}", flush=True)
    check(all(c["ok"] for c in doc["checks"].values()), "every doctor check on the card")
    return res


def committed_weights(weights_dir: str):
    """(absolute path, case, checkpoint meta) of a committed weights
    directory, printing its step, loader and learned tau."""
    import torch

    from tpuflow_torch.tools import weights_reference as wr
    from tpuflow_torch.train import Checkpointer

    weights = pathlib.Path(__file__).resolve().parent / weights_dir
    case = wr.case_of(weights)
    ckpt = Checkpointer(weights / case)
    meta = ckpt.restore(map_location="cpu")["meta"]
    print(f"  {weights_dir} ({case}): step {ckpt.latest_step()} loaded by torch "
          f"{torch.__version__}; fixture v{meta['config']['data']['fixture_version']}, learned "
          f"tau {meta['learned_tau']}", flush=True)
    return weights, case, meta


def k2_captured_times(run, label: str) -> list[dict]:
    """K2 on the inputs a model's own rollout gives it: ``run()`` drives the
    model while the coupling's calls to K2 are recorded, and the first call
    at each shape is timed in a CUDA graph of 20 beside its bound and its
    plain version (and cuDNN's five bf16 convs at its shape, a yardstick),
    as :func:`k2_times` times random inputs."""
    import torch

    from tpuflow_torch.flows import coupling
    from tpuflow_torch.kernels.coupling_fused import fused_coupling, fused_coupling_reference

    calls: dict = {}
    orig = coupling.fused_coupling

    def record(xa, xb, h0c, net, *, reverse=False):
        key = (tuple(xa.shape), reverse)
        if key not in calls:
            calls[key] = (xa.clone(), xb.clone(), None if h0c is None else h0c.clone(), net)
        return orig(xa, xb, h0c, net, reverse=reverse)

    coupling.fused_coupling = record
    try:
        run()
    finally:
        coupling.fused_coupling = orig
    out = []
    for (shape, reverse), (xa, xb, h0c, net) in calls.items():
        b, h, w, ca = shape
        ms = time_graph_ms(lambda: fused_coupling(xa, xb, h0c, net, reverse=reverse), 20)
        plain_ms = time_graph_ms(
            lambda: fused_coupling_reference(xa, xb, h0c, net, reverse=reverse), 20)
        chain_ms = cudnn_chain_ms(b, h, w, ca, net.width, net.growth, net.layers, xa.device)
        bound_ms, bound_by, _, _ = k2_bound(xa, xb, h0c, net, net.growth, net.layers)
        out.append(dict(shape=list(shape), reverse=reverse, ms=ms, plain_ms=plain_ms,
                        cudnn_chain_ms=chain_ms, bound_ms=bound_ms, bound_by=bound_by))
        print(f"  K2 on {label}, {'reverse' if reverse else 'forward'} {list(shape)}, "
              f"{'fused' if net.fused else 'default'} numerics: {ms:.5f} ms/launch in a graph "
              f"(bound {bound_ms:.5f} ms by {bound_by}); plain version {plain_ms:.4f} ms; "
              f"cuDNN's five bf16 convs {chain_ms:.5f} ms [{SMI[0]}]", flush=True)
    return out


def flagship_phase(dev, weights_dir: str, overrides=()) -> dict:
    """Committed trained weights (``FLAGSHIP_DIRS``: ``tools/export_to_torch.py``
    of a fine-tuned JAX checkpoint, with a learned per-scale tau in its meta)
    through the rollout CLI's compute half at the case preset's members and
    steps, bf16 nets, in the checkpoint's fixture and numerics, the overflow
    redraw off: every statistic finite, K2 counted over the warm-up, the
    timed run and the samples grid, and timed on the rollout's own inputs.
    Then, held to the CPU and to the CPU's ``reference.json`` beside the
    weights (``tpuflow_torch.tools.weights_reference``): the f32 rollout on
    draws made on the CPU, card against CPU in this call, at SLICE_TOL x
    max(1, max |ref|); the bf16 held-out bits/dim at 8 steps and at the
    evaluator's step count, at FLAGSHIP_TOL_BPD relative; the latter in the
    other numerics too, beside the TPU's, for information. ``overrides``
    (key=value) shrink the CLI run for a rehearsal."""
    import json
    import tempfile

    import numpy as np
    import torch

    from tpuflow_torch.cli import rollout as rollout_cli
    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.eval import load_eval_bundle, make_ensemble_rollout, resolve_temperature
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.tools import weights_reference as wr

    weights, case_name, meta = committed_weights(weights_dir)
    want = json.loads((weights / "reference.json").read_text())
    check(want["case"] == case_name, f"{weights_dir}/reference.json is {case_name}'s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flagship_") as tmp:
        args = [f"train.checkpoint_dir={weights}",
                f"data.fixture_version={meta['config']['data']['fixture_version']}",
                "eval.overflow_redraw=false", f"eval.output_dir={tmp}", *overrides]
        cfg = load_case(case_name, parse_cli_overrides(args))
        check(cfg.model.compute_dtype == "bfloat16" and not cfg.eval.overflow_redraw,
              "bf16 nets, the redraw off")
        check(not cfg.model.use_pallas and meta["config"]["model"]["use_pallas"] is False,
              "the weights roll out in their checkpoint's numerics, the default path's")
        coupling_fused.launches = 0
        metrics, _ = rollout_cli.rollout(cfg, dev)
        torch.cuda.synchronize()
        launches = coupling_fused.launches
        with np.load(pathlib.Path(tmp) / case_name / "rollout_stats.npz") as f:
            stats = {k: f[k] for k in f.files}
    T, n = metrics["steps"], metrics["n_samples"]
    t_mid = min(T, cfg.data.train_steps) // 2
    per_step = cfg.model.n_scales * cfg.model.n_flow_steps
    expected = per_step * (2 * T + t_mid + 1)
    print(f"  {n} members x {T} steps at {cfg.model.hf_shape}, bf16, learned tau "
          f"{metrics['temperature']}, redraw off: {metrics['rollout_steps_per_sec']:.3f} steps/s "
          f"(the CLI's timed run) [{SMI[0]}]; K2 launches {launches} (expected {per_step} x "
          f"({T} x 2 runs + {t_mid + 1} samples-grid steps))", flush=True)
    check(launches == expected, f"K2 launch count of the {case_name} rollout")
    check(all(abs(a - b) < 1e-6 for a, b in zip(metrics["temperature"], meta["learned_tau"])),
          f"{case_name} rolls out at its learned tau")
    shape = (T, *cfg.model.hf_shape, cfg.model.channels)
    for k, v in stats.items():
        print(f"  {k}: finite {bool(np.isfinite(v).all())}, max |{k}| {np.abs(v).max():.4f}",
              flush=True)
        check(v.shape == shape and bool(np.isfinite(v).all()),
              f"{case_name} {k} {v.shape} finite with the redraw off")
    check(bool((stats["var"] >= 0).all()), f"{case_name} var >= 0")
    res = {"launches": launches, "steps_per_sec": metrics["rollout_steps_per_sec"],
           "f32_err": {}, "f32_err_vs_reference": {}}

    # K2 on the trained nets: one rollout step of the preset's members.
    model, norm, bundle_meta = load_eval_bundle(cfg, device=dev)
    lf = torch.from_numpy(load_dataset(cfg.data, cfg.model, "test", norm=norm).lf[0, :1]).to(dev)
    roll = make_ensemble_rollout(model, n, resolve_temperature(cfg, bundle_meta, device=dev))
    res["k2_shapes"] = k2_captured_times(
        lambda: roll(lf, torch.Generator(dev).manual_seed(0)), f"{case_name}'s trained nets")
    del model, roll

    # f32 on the CPU's draws: the card against the CPU, and both against
    # the committed reference.json.
    ref = want["rollout"]
    check((ref["seed"], ref["n_samples"], ref["steps"], ref["grid"]) == (
        wr.ROLLOUT_SEED, wr.ROLLOUT_MEMBERS, wr.ROLLOUT_STEPS, wr.GRID),
        "reference.json's rollout settings")
    t0 = time.perf_counter()
    cpu = wr.f32_rollout(weights, "cpu")
    t_cpu = time.perf_counter() - t0
    coupling_fused.launches = 0
    t0 = time.perf_counter()
    card = wr.f32_rollout(weights, dev)
    t_card = time.perf_counter() - t0
    check(coupling_fused.launches == per_step * wr.ROLLOUT_STEPS,
          "K2 launch count of the f32 comparison rollout")
    for k in ("mean", "var"):
        scale = max(1.0, cpu[k].abs().max().item())
        err = (card[k] - cpu[k]).abs().max().item()
        res["f32_err"][k] = err
        print(f"  f32 {ref['n_samples']} x {ref['steps']} (seed {ref['seed']}) {k}: card vs CPU "
              f"max abs err {err:.3e} (tol {SLICE_TOL} x {scale:.3f}); card {t_card:.2f} s, "
              f"CPU {t_cpu:.2f} s [{SMI[0]}]", flush=True)
        check(bool(torch.isfinite(card[k]).all()) and err <= SLICE_TOL * scale,
              f"{case_name} f32 rollout {k}, card vs CPU")
    for name, got in (("card", wr.summarize(card)), ("CPU", wr.summarize(cpu))):
        for k in ("mean", "var"):
            scale = max(1.0, max(ref["stats"][k]["max_abs"]))
            err = float(max(abs(a - b) for f in ("max_abs", "mean", "grid")
                            for a, b in zip(np.ravel(got[k][f]), np.ravel(ref["stats"][k][f]))))
            if name == "card":
                res["f32_err_vs_reference"][k] = err
            print(f"  f32 {k}, {name} vs reference.json: max abs err {err:.3e} "
                  f"(tol {SLICE_TOL} x {scale:.3f})", flush=True)
            check(err <= SLICE_TOL * scale, f"{case_name} f32 {k}, {name} vs reference.json")

    # bf16 held-out bits/dim: 8 steps, then the evaluator's step count in
    # the checkpoint's numerics (both gated) and in the fused ones (not).
    tpu = TPU_EVAL[weights_dir]["test_bpd"]
    res["bpd_rel_err"], res["test_bpd_by_numerics"] = {}, {}
    for key, name in (("bpd", "default"), ("test_bpd", "default"), ("test_bpd", "fused")):
        t0 = time.perf_counter()
        over = {"model.use_pallas": name == "fused"}
        steps, v = ((wr.BPD_STEPS, wr.heldout_bpd(weights, dev, **over)) if key == "bpd"
                    else wr.evaluator_bpd(weights, dev, **over))
        line = (f"  bf16 held-out bits/dim, {steps} steps x 4 trajectories, {name} numerics: "
                f"card {v:.6f}")
        check(math.isfinite(v) and steps == want[key]["steps"], f"{case_name} {key} finite")
        if key == "test_bpd":
            res["test_bpd_by_numerics"][name] = v
            line += f" (the TPU's evaluation {tpu:.6f}, default numerics; not a gate)"
        if name == "default":
            rel = abs(v - want[key]["value"]) / abs(want[key]["value"])
            res["bpd_rel_err"][key] = rel
            res[key] = v
            line += (f", reference.json (CPU) {want[key]['value']:.6f}, relative {rel:.3e} "
                     f"(tol {FLAGSHIP_TOL_BPD})")
            check(rel <= FLAGSHIP_TOL_BPD, f"{case_name} bf16 {key} vs reference.json")
        print(f"{line}; {time.perf_counter() - t0:.2f} s [{SMI[0]}]", flush=True)
    return res


def step_split(fn, steps: int) -> dict | None:
    """Where the device time of ``fn()``, ``steps`` rollout steps, goes:
    its kernels under ``torch.profiler`` (device activity only), per step:
    their summed device ms, K2's share of it (by kernel name), the kernels
    launched and the five largest. None if the profiler saw no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpuflow_torch.tools.profile_rollout import device_time_by_kernel

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_time_by_kernel(prof.events())
    if not rows:
        return None
    top = sorted(((ms / steps, n / steps, k[:80]) for (_, k), (ms, n) in rows.items()),
                 reverse=True)[:5]
    return {"busy_ms": sum(ms for ms, _ in rows.values()) / steps,
            "k2_ms": sum(ms for (g, _), (ms, _) in rows.items() if g == "K2") / steps,
            "kernels": sum(n for _, n in rows.values()) / steps, "top": top}


def deploy_phase(dev, overrides=()) -> dict:
    """The JAX package's deployment chain on the committed backward-step
    flagship (``FLAGSHIP_DIRS[0]``), in order, each stage with the K2 count
    set to 0 just before it and read just after:

      * evaluate: ``cli.evaluate.evaluate`` (the CLI's compute half; its
        ``main`` where matplotlib is installed) at the preset (fixture v3,
        64 members, 4 test trajectories batched at K2's B = 256, 32
        calibration and 256 reference steps) into a temporary
        ``eval.output_dir``: every metric finite, coverages in [0, 1], the
        fitted ``spread_scale`` and ``interval_scales`` positive, ``test_bpd``
        within FLAGSHIP_TOL_BPD of ``reference.json``; the sampled metrics
        beside the TPU's evaluation, for information;
      * export: ``tools.export_rollout.main`` from that directory at bf16 in
        the checkpoint's numerics, the learned tau as the default: the
        sidecar carries the evaluation's ``spread_scale`` and
        ``interval_scales``;
      * load: ``tools.serve.RolloutServer``;
      * serve: 64 members x 100 steps (the LF wrap-tiled over the 64 stored
        steps, as the rollout CLI tiles it), the served stats against
        ``make_ensemble_rollout`` on the same seed at SERVE_TOL (bit-equality
        reported), the calibrated variance equal to the variance times
        ``spread_scale`` squared with the mean unchanged, K2 at 24 launches
        per served step; served and eager steps/s in SERVE_PAIRS
        interleaved pairs, then each step's kernels under ``torch.profiler``
        against its untraced time (:func:`step_split`);
      * HTTP: one ``POST /rollout?calibrated=1`` on localhost in physical
        units, its bytes against Content-Length and its arrays equal to the
        direct call's.

    ``overrides`` (key=value) shrink it for a rehearsal."""
    import io
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from tpuflow_torch.cli import evaluate as evaluate_cli
    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.eval import (
        load_eval_bundle,
        make_batched_ensemble_rollout,
        make_ensemble_rollout,
        resolve_temperature,
    )
    from tpuflow_torch.eval.metrics import METRIC_KEYS, key_structure
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.tools import export_rollout
    from tpuflow_torch.tools.serve import RolloutServer, make_http_server

    weights_dir = FLAGSHIP_DIRS[0]
    weights, case_name, meta = committed_weights(weights_dir)
    want = json.loads((weights / "reference.json").read_text())["test_bpd"]
    tpu = TPU_EVAL[weights_dir]
    res: dict = {"launches_by_stage": {}, "seconds": {}}

    def stage(name, fn):
        """``fn()`` with K2 counted and its seconds kept."""
        coupling_fused.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["seconds"][name] = time.perf_counter() - t0
        res["launches_by_stage"][name] = coupling_fused.launches
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as tmp:
        args = [f"train.checkpoint_dir={weights}",
                f"data.fixture_version={meta['config']['data']['fixture_version']}",
                f"eval.output_dir={tmp}", *overrides]
        case = load_case(case_name, parse_cli_overrides(args))
        e, mc = case.eval, case.model
        if not overrides:
            check(e.n_samples == 64 and e.traj_batch == 4 and e.calibration_steps == 32
                  and e.ref_steps == 256 and e.rollout_steps == 100, "the preset's eval section")
        check(mc.compute_dtype == "bfloat16" and not mc.use_pallas,
              "bf16 nets in the checkpoint's numerics, the default path's")

        # evaluate
        seconds: dict = {}
        if has_matplotlib():
            metrics = stage("evaluate", lambda: evaluate_cli.main(
                [case_name, *args, "--device", dev.type], seconds))
        else:
            print(f"  figures: not drawn on the card: matplotlib is not installed here, so "
                  f"{evaluate_cli.PROG} stops at its start; ran its compute half", flush=True)
            metrics = stage("evaluate", lambda: evaluate_cli.evaluate(case, dev, seconds)[0])
        launches = res["launches_by_stage"]["evaluate"]
        per_step = mc.n_scales * mc.n_flow_steps
        T, n_traj = metrics["steps"], case.data.n_test_traj
        t_cal = min(e.calibration_steps, T)
        chunks = -(-n_traj // min(e.traj_batch, n_traj))
        n_fit, n_hold = len(range(0, n_traj, 2)), len(range(1, n_traj, 2))
        cal_runs = 1 + 2 * (n_fit - 1) + n_hold  # as evaluate_phase counts them
        expected = per_step * (T + chunks * T + cal_runs * t_cal)
        # A redraw re-runs one step of the reverse: 24 more launches each.
        redraws, rest = divmod(launches - expected, per_step)
        res["redraws"] = redraws
        b = min(e.traj_batch, n_traj) * e.n_samples
        print(f"  evaluate: {n_traj} trajectories x {e.n_samples} members (K2 at B = {b}), {T} "
              f"steps, calibration {t_cal}, reference {metrics['ref_steps']}: "
              f"{res['seconds']['evaluate']:.2f} s; K2 launches {launches} (expected {per_step} x "
              f"({T} NLL + {chunks} x {T} batched + {cal_runs} x {t_cal} calibration) = "
              f"{expected}); overflow redraw {'on' if e.overflow_redraw else 'off'}, "
              f"fired {redraws} times", flush=True)
        print(f"  stage seconds ({SMI[0]}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()), flush=True)
        check(rest == 0 and redraws >= 0 and (e.overflow_redraw or redraws == 0),
              "K2 launch count of the evaluator on the flagship")
        check(key_structure(metrics) == METRIC_KEYS, "eval_metrics.json has the 102 keys")
        bad = [k for k, v in metrics.items() if not all(math.isfinite(x) for x in numbers(v))]
        check(not bad, f"every metric of the flagship's evaluation finite (not: {bad})")
        coverages = [x for k, v in metrics.items() if k.startswith("coverage")
                     for x in numbers(v)]
        check(coverages and all(0.0 <= x <= 1.0 for x in coverages), "coverages in [0, 1]")
        check(metrics["spread_scale"] > 0 and all(v > 0 for v in
                                                  metrics["interval_scales"].values()),
              "fitted spread_scale and interval_scales > 0")
        rel = abs(metrics["test_bpd"] - want["value"]) / abs(want["value"])
        res.update(test_bpd=metrics["test_bpd"], test_bpd_rel_err=rel,
                   spread_scale=metrics["spread_scale"],
                   interval_scales=metrics["interval_scales"], crps_mean=metrics["crps_mean"],
                   field_rel_l2_mean=metrics["field_rel_l2_mean"])
        print(f"  test_bpd {metrics['test_bpd']:.6f} ({T} steps), reference.json (CPU) "
              f"{want['value']:.6f} ({want['steps']} steps), relative {rel:.3e} (tol "
              f"{FLAGSHIP_TOL_BPD})", flush=True)
        print(f"  sampled, not a gate (card / the TPU's evaluation): spread_scale "
              f"{metrics['spread_scale']:.4f} / {tpu['spread_scale']:.4f}, test_bpd "
              f"{metrics['test_bpd']:.4f} / {tpu['test_bpd']:.4f}; interval_scales "
              f"{metrics['interval_scales']}, coverage {metrics['coverage']}, crps_mean "
              f"{metrics['crps_mean']:.5f}, field_rel_l2_mean "
              f"{metrics['field_rel_l2_mean']:.4f}", flush=True)
        check(T == want["steps"] and rel <= FLAGSHIP_TOL_BPD,
              "the evaluator's test_bpd against reference.json")

        # export
        path = stage("export", lambda: export_rollout.main(
            [case_name, *args, "--device", dev.type]))
        sidecar = json.loads(path.with_suffix(".meta.json").read_text())
        res["bytes"] = path.stat().st_size
        print(f"  export: {res['seconds']['export']:.2f} s, {res['bytes']} bytes; sidecar "
              f"spread_scale {sidecar.get('spread_scale')}, interval_scales "
              f"{sidecar.get('interval_scales')}, default_temperature "
              f"{sidecar['default_temperature']}", flush=True)
        check(sidecar.get("spread_scale") == metrics["spread_scale"]
              and sidecar.get("interval_scales") == metrics["interval_scales"],
              "the sidecar carries the evaluation's calibration")
        check(all(abs(a - b) < 1e-6 for a, b in zip(sidecar["default_temperature"],
                                                      meta["learned_tau"]))
              and (sidecar["n_samples"], sidecar["rollout_steps"]) == (e.n_samples,
                                                                         e.rollout_steps),
              "the sidecar's learned tau, members and steps")

        # load
        server = stage("load", lambda: RolloutServer(path, device=dev))
        print(f"  load: {res['seconds']['load']:.2f} s", flush=True)

        # serve
        model, norm, bundle_meta = load_eval_bundle(case, device=dev)
        ds = load_dataset(case.data, case.model, "test", norm=norm)
        steps, n = e.rollout_steps, e.n_samples
        lf = np.concatenate([ds.lf[0]] * -(-steps // ds.n_steps))[:steps]
        lf_dev = torch.from_numpy(lf).to(dev)
        tau = resolve_temperature(case, bundle_meta, device=dev)
        # K2 on the trained nets at the evaluator's batch: one step of its
        # batched rollout over traj_batch trajectories.
        b_traj = min(e.traj_batch, ds.n_traj)
        lfs = torch.from_numpy(ds.lf[:b_traj, :1]).to(dev)
        res["k2_shapes"] = k2_captured_times(
            lambda: make_batched_ensemble_rollout(model, n, tau)(
                lfs, [torch.Generator(dev).manual_seed(i) for i in range(b_traj)]),
            f"{case_name}'s trained nets, the evaluator's batch")
        eager = make_ensemble_rollout(model, n, tau, "stats")
        server.rollout(lf, seed=3, normalized=True)  # warm-up: cuDNN plans, the allocator
        eager(lf_dev[:2], torch.Generator(dev).manual_seed(3))
        plain = stage("serve", lambda: server.rollout(lf, seed=4, normalized=True))
        served_launches = res["launches_by_stage"]["serve"]
        cal = server.rollout(lf, seed=4, normalized=True, calibrated=True)
        with torch.no_grad():
            ref = eager(lf_dev, torch.Generator(dev).manual_seed(4))
        ref = {"mean": ds.denorm_hf(ref["mean"]).cpu().numpy(),
               "var": ds.denorm_hf_var(ref["var"]).cpu().numpy()}
        err = max(float(np.abs(plain[k] - ref[k]).max()) / max(1.0, float(np.abs(ref[k]).max()))
                  for k in ref)
        bit_equal = all(np.array_equal(plain[k], ref[k]) for k in ref)
        s2 = np.float32(sidecar["spread_scale"]) ** 2
        res.update(served_launches=served_launches, served_vs_eager_max_rel_err=err,
                   served_bit_equal_eager=bit_equal)
        print(f"  serve: {n} members x {steps} steps, K2 launches {served_launches} (expected "
              f"{per_step} x {steps}); served vs eager stats {err:.3e} of max(1, max |ref|) (tol "
              f"{SERVE_TOL['bfloat16']}), bit-equal {bit_equal}; calibrated var = var x "
              f"{sidecar['spread_scale']:.6f}^2: "
              f"{np.array_equal(cal['var'], plain['var'] * s2)}, mean unchanged "
              f"{np.array_equal(cal['mean'], plain['mean'])}", flush=True)
        check(served_launches == per_step * steps, "K2 launch count of the served flagship")
        check(all(p.shape == (steps, *mc.hf_shape, mc.channels) and bool(np.isfinite(p).all())
                  for p in plain.values()), "served flagship stats finite")
        check(err <= SERVE_TOL["bfloat16"], "served flagship stats against the eager rollout")
        check(np.array_equal(cal["mean"], plain["mean"])
              and np.array_equal(cal["var"], plain["var"] * s2),
              "calibrated variance = variance x spread_scale^2, the mean unchanged")
        rates: dict = {"served": [], "eager": []}
        for i in range(SERVE_PAIRS):
            runs = (("served", lambda: server.rollout(lf, seed=10 + i, normalized=True)),
                    ("eager", lambda: eager(lf_dev, torch.Generator(dev).manual_seed(10 + i))))
            for name, run in runs:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                rates[name].append(steps / (time.perf_counter() - t0))
        ratio = sorted(s / e for s, e in zip(rates["served"], rates["eager"]))[SERVE_PAIRS // 2]
        print(f"  {n} x {steps} steps/s, {SERVE_PAIRS} interleaved pairs: served "
              f"{', '.join(f'{r:.3f}' for r in rates['served'])}; eager "
              f"{', '.join(f'{r:.3f}' for r in rates['eager'])}; median served / eager "
              f"{ratio:.3f} [{SMI[0]}]", flush=True)
        res.update(served_steps_per_sec=rates["served"], eager_steps_per_sec=rates["eager"],
                   served_over_eager=ratio)
        # Where a step's time goes, served and eager: the device's kernels
        # against the untraced step (the median of the pairs).
        res["step_split"] = {}
        for name, run in (("served", lambda: server.rollout(lf, seed=20, normalized=True)),
                          ("eager", lambda: eager(lf_dev, torch.Generator(dev).manual_seed(20)))):
            split = step_split(run, steps)
            wall_ms = 1e3 / sorted(rates[name])[SERVE_PAIRS // 2]
            if split is None:
                print(f"  {name} step: device time not measured (the profiler saw no kernel)",
                      flush=True)
                continue
            split.update(wall_ms=wall_ms, idle_share=1 - split["busy_ms"] / wall_ms)
            res["step_split"][name] = split
            print(f"  {name} step: {wall_ms:.3f} ms untraced, kernels {split['busy_ms']:.3f} ms "
                  f"({split['kernels']:.0f} per step; K2 {split['k2_ms']:.3f} ms), device idle "
                  f"{100 * split['idle_share']:.1f}% [{SMI[0]}]; largest: "
                  + "; ".join(f"{ms:.3f} ms {n:.0f}x {k}" for ms, n, k in split["top"]),
                  flush=True)

        # HTTP, in physical units: the response against the direct call's.
        lf_phys = ds.denorm_lf(lf)
        direct = server.rollout(lf_phys, seed=4)
        httpd = make_http_server(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            buf = io.BytesIO()
            np.savez(buf, lf=lf_phys)
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/rollout?seed=4&calibrated=1",
                data=buf.getvalue(), method="POST")

            def post():
                with urllib.request.urlopen(req, timeout=300) as resp:
                    return resp.read(), int(resp.headers["Content-Length"])

            body, length = stage("http", post)
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join()
        with np.load(io.BytesIO(body)) as got:
            got = {k: got[k] for k in got.files}
        ok = (set(got) == {"mean", "var"} and np.array_equal(got["mean"], direct["mean"])
              and np.array_equal(got["var"], direct["var"] * s2))
        res.update(http_s=res["seconds"]["http"], http_bytes=len(body))
        print(f"  HTTP POST /rollout?calibrated=1 on localhost: {res['http_s']:.3f} s, "
              f"{len(body)} bytes (Content-Length {length}); mean = the direct call's, var = "
              f"its var x spread_scale^2: {ok}; K2 launches "
              f"{res['launches_by_stage']['http']}", flush=True)
        check(len(body) == length, "HTTP response bytes against Content-Length")
        check(ok, "the calibrated HTTP response against the direct call")
        check(res["launches_by_stage"]["http"] == per_step * steps, "K2 launches of the request")
    res["launches"] = sum(res["launches_by_stage"].values())
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16,
                    help="rollout steps of the main-path run (default 16)")
    # A rank of the "data parallel" phase, started by the script itself.
    ap.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-dir", default=None, help=argparse.SUPPRESS)
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
    if args.dp_rank is not None:
        return dp_worker(args.dp_rank, args.dp_port, args.dp_dir)

    with phase("device"):
        dev = resolve_device("cuda")
        device_name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}; device {device_name}")
        print(smi, flush=True)
        SMI[0] = smi
        spec = importlib.util.find_spec("matplotlib")
        if spec is None:
            print("  matplotlib: not installed (importlib.util.find_spec returned None)")
        else:
            import matplotlib

            print(f"  matplotlib {matplotlib.__version__} ({spec.origin})", flush=True)

    with phase("build"):
        sources = ("coupling_fused", "coupling_apply")
        _build.build(*sources)  # one nvcc per source, started together; prints -Xptxas -v
        for source in sources:
            _build.load(source)
        # Evidence that the bf16 path runs on the tensor cores.
        hmma = sass_count(_build._paths("coupling_fused")[1], "conv3x3_mma_kernel", "HMMA")
        if hmma is None:
            print("  HMMA in the bf16 conv kernel's SASS: not checked (no cuobjdump); the "
                  f"source uses mma.sync ({K2_SOURCE})", flush=True)
        else:
            for fn, n in hmma.items():
                print(f"  HMMA instructions in {fn}: {n}", flush=True)
            check(len(hmma) == 3 and all(hmma.values()),
                  "every instantiation of the bf16 conv kernel holds HMMA instructions")
        # Evidence that K1 streams 16-byte vectors: 128-bit global loads
        # (LDG.E.128, with any cache-hint suffix) in both instantiations.
        ldg = sass_count(_build._paths("coupling_apply")[1], "coupling_apply_kernel",
                         r"\bLDG\.E(\.\w+)*\.128\b")
        if ldg is None:
            print("  128-bit loads in K1's SASS: not checked (no cuobjdump); the source uses "
                  f"__ldcs on float4 ({K1_SOURCE})", flush=True)
        else:
            for fn, n in ldg.items():
                print(f"  128-bit global loads (LDG.E.128) in {fn}: {n}", flush=True)
            check(len(ldg) == 2 and all(ldg.values()),
                  "both instantiations of K1 hold 128-bit global loads")

    case = load_case("backward-step")
    cfg = case.model
    with phase("kernel vs plain"):
        k2 = kernel_phase(cfg, dev)

    with phase("K1 vs plain"):
        k1 = k1_phase(dev)
        k1["launches"] = k1_path_phase(dev)

    with phase("slice"):
        launches, steps_per_s, rollout_ms, share, rates = slice_phase(cfg, dev, args.steps)
        for s, ms in zip(k2["shapes"], rollout_ms):
            s["rollout_ms"] = ms
        k2["share_of_step"] = share
        k2["rollout_steps_per_sec_by_numerics"] = rates
        print(f"  K2 bound per rollout step "
              f"{sum(s['bound_ms'] for s in k2['shapes']) * cfg.n_flow_steps:.4f} ms",
              flush=True)

    with phase("reference"):
        reference_phase(cfg, dev)

    with phase("train"):
        train = train_phase(case, dev)
        train.update(train_parity_phase(case, dev))
        train.update(train_share_phase(case, dev))

    with phase("rollout CLI"):
        cli = rollout_cli_phase(dev)

    flagships = {}
    for weights_dir in FLAGSHIP_DIRS:
        with phase(f"flagship {weights_dir}"):
            flagships[weights_dir] = flagship_phase(dev, weights_dir)

    with phase("deploy"):
        deployed = deploy_phase(dev)

    with phase("cylinder"):
        cyl = cylinder_phase(dev)

    with phase("batched"):
        batched = batched_phase(cfg, dev)

    with phase("redraw"):
        redraw = redraw_phase(cfg, dev, args.steps)

    with phase("evaluate"):
        evaluated = evaluate_phase(cfg, dev)

    with phase("finetune"):
        finetuned = finetune_phase(case, dev)

    with phase("data parallel"):
        parallel = data_parallel_phase(dev)

    with phase("split"):
        split = split_phase(cfg, dev, args.steps)

    with phase("stream"):
        streamed = stream_phase(dev)

    with phase("serve"):
        served = serve_phase(case, dev, args.steps)

    with phase("tools"):
        tools = tools_phase(case, dev)

    k2["launches"] = launches
    k2["max_abs_err"] = max(k2["max_abs_err"], cyl["max_abs_err"],
                            evaluated.pop("k2_parity_max_abs_err"),
                            finetuned.pop("k2_parity_max_abs_err"), split.pop("max_abs_err"),
                            tools.pop("k2_width128_max_abs_err"))
    k2["launches_by_path"] = {"rollout": launches, "train": train.pop("launches")}
    k2["launches_by_path"]["data_parallel_nccl"] = parallel.pop("nccl_launches")
    for name, res in (("rollout_cli", cli), ("flagship", flagships[FLAGSHIP_DIRS[0]]),
                      ("flagship_cylinder", flagships[FLAGSHIP_DIRS[1]]), ("deploy", deployed),
                      ("cylinder", cyl), ("batched", batched), ("redraw", redraw),
                      ("evaluate", evaluated), ("finetune", finetuned),
                      ("data_parallel", parallel), ("split", split), ("stream", streamed),
                      ("serve", served), ("tools", tools)):
        k2["launches_by_path"][name] = res.pop("launches")
        k2[name] = res
    k2["train"] = train
    print(smi)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
