"""Profile the port's ensemble rollout on the GPU and split its step.

    python -m tpuflow_torch.tools.profile_rollout [--case backward-step] [--steps 16]
                                                  [--top 15] [--trace PATH]

Builds the case's model at full width from a seeded init (every
parameter perturbed by 0.004, see ``tpuflow_torch.models.perturb_``),
runs the 64-member stats rollout once as a warm-up, once untraced on
the host clock, and once under ``torch.profiler`` (CPU and CUDA
activities) with the model's modules annotated (:func:`annotate`). It
prints the wall time per step, the device time per step summed over
every kernel, the device's idle
share of the untraced step (the kernels run on one stream, so their
times do not overlap; the profiler slows the host, not the kernels), and
the device time grouped by :func:`group_of` into K2 / conditioning /
inv-1x1 / priors / ActNorm / other, with each group's largest kernels.
``--trace`` also writes the Chrome trace. Needs a GPU.

A kernel is grouped by the innermost annotated module around the runtime
call that launched it; K2's kernels, launched through ``ctypes``, by
name.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import time
from collections import defaultdict
from collections.abc import Sequence

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# Kernel names of K2 (csrc/coupling_fused.cu), bf16 and f32 paths.
K2_KERNELS = ("conv3x3_mma_kernel", "conv3x3_kernel", "ld_reduce_kernel", "affine_logdet_kernel")
N_MEMBERS = 64
GROUPS = ("K2", "conditioning", "inv-1x1", "priors", "ActNorm", "other")
_LABEL = "tpf::"
# (group, module, class, method) annotated while tracing. The coupling's
# conv_in_1 (``cond_conv``) projects the conditioning, so it counts
# there; the LF encoder and the inverse 1x1 caches run once per rollout.
# The rest (the coupling's split of x, squeeze, the Glow loop's sums, the
# ensemble stats, the weight packing) is "other".
ANNOTATED = (
    ("conditioning", "tpuflow_torch.models.tmglow", "TMGlow", "condition"),
    ("conditioning", "tpuflow_torch.models.tmglow", "TMGlow", "encode_lf"),
    ("conditioning", "tpuflow_torch.flows.coupling", "DenseBlockNet", "cond_conv"),
    ("inv-1x1", "tpuflow_torch.flows.inv1x1", "InvConv1x1LU", "forward"),
    ("inv-1x1", "tpuflow_torch.models.tmglow", "TMGlow", "build_inv_caches"),
    ("ActNorm", "tpuflow_torch.flows.actnorm", "ActNorm", "forward"),
    ("priors", "tpuflow_torch.flows.split", "ConditionalSplit", "forward"),
    ("priors", "tpuflow_torch.flows.split", "ConditionalSplit", "reverse"),
    ("priors", "tpuflow_torch.flows.split", "ConditionalPrior", "forward"),
    ("priors", "tpuflow_torch.flows.split", "ConditionalPrior", "reverse"),
)


@contextlib.contextmanager
def annotate():
    """Wrap each method of :data:`ANNOTATED` in a ``record_function``
    range named ``tpf::<group>``; restore them on exit."""
    saved = []

    def wrap(fn, label):
        def annotated(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return annotated

    try:
        for group, module, cls_name, name in ANNOTATED:
            cls = getattr(importlib.import_module(module), cls_name)
            saved.append((cls, name, cls.__dict__[name]))
            setattr(cls, name, wrap(cls.__dict__[name], _LABEL + group))
        yield
    finally:
        for cls, name, fn in reversed(saved):
            setattr(cls, name, fn)


def group_of(kernel: str, stack: Sequence[str]) -> str:
    """Group of a kernel named ``kernel`` whose launching call sits under
    the CPU events ``stack`` (innermost first: ops and annotations)."""
    if any(k in kernel for k in K2_KERNELS):
        return "K2"
    for name in stack:
        if name.startswith(_LABEL):
            return name[len(_LABEL):]
    return "other"


def stack_of(event) -> list[str]:
    """Names of a profiled CPU event's ancestors, innermost first."""
    names, parent = [], event.cpu_parent
    while parent is not None:
        names.append(parent.name)
        parent = parent.cpu_parent
    return names


def device_time_by_kernel(events) -> dict[tuple[str, str], list[float]]:
    """{(group, kernel name): [device ms, launches]} from ``prof.events()``.

    A kernel is grouped by the ancestors of the runtime call that launched
    it (``cudaLaunchKernel`` and the like: the CPU event with the
    kernel's correlation id). Memory copies and sets count as kernels."""
    launchers = {e.id: e for e in events
                 if e.device_type.name == "CPU" and e.name.startswith(("cuda", "cu"))}
    rows: dict[tuple[str, str], list[float]] = defaultdict(lambda: [0.0, 0])
    for e in events:
        # An annotation's range shows on the device timeline too: not a kernel.
        if e.device_type.name != "CUDA" or e.name.startswith(_LABEL):
            continue
        stack = stack_of(launchers[e.id]) if e.id in launchers else []
        row = rows[(group_of(e.name, stack), e.name)]
        row[0] += (e.time_range.end - e.time_range.start) / 1e3
        row[1] += 1
    return dict(rows)


def by_group(rows: dict[tuple[str, str], list[float]]) -> dict[str, float]:
    """Device ms per group, every group of :data:`GROUPS` present."""
    out = dict.fromkeys(GROUPS, 0.0)
    for (group, _), (ms, _) in rows.items():
        out[group] += ms
    return out


def run(case: str, dev: torch.device, steps: int, top: int = 15, trace: str = "",
        overrides: Sequence[str] = ()) -> dict:
    """Warm-up, untraced and traced rollouts; prints and returns the split."""
    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.eval import make_ensemble_rollout
    from tpuflow_torch.models import TMGlow, perturb_

    cfg = load_case(case, parse_cli_overrides(list(overrides))).model
    model = TMGlow(cfg, device=dev, seed=0)
    perturb_(model, 1)
    gen = torch.Generator().manual_seed(2)
    lf = torch.randn(steps, *cfg.lf_shape, cfg.channels, generator=gen).to(dev)
    rollout = make_ensemble_rollout(model, N_MEMBERS, 0.85, "stats")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rollout(lf[:2], torch.Generator(dev).manual_seed(3))  # warm-up: cuDNN plans, allocator
    sync()
    t0 = time.perf_counter()
    rollout(lf, torch.Generator(dev).manual_seed(4))
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with annotate(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(lf, torch.Generator(dev).manual_seed(4))
        sync()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = device_time_by_kernel(prof.events())
    groups = {g: ms / steps for g, ms in by_group(rows).items()}
    busy_ms = sum(groups.values())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{name}; {case} rollout, {N_MEMBERS} members x {steps} steps, "
          f"{cfg.compute_dtype} nets")
    print(f"step {wall_ms:.3f} ms untraced ({1e3 / wall_ms:.2f} steps/s), {traced_ms:.3f} ms "
          f"traced; kernels {busy_ms:.3f} ms per step "
          f"({sum(n for _, n in rows.values()) / steps:.0f} launches); device idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% of the untraced step")
    for g in GROUPS:
        print(f"  {g:13s} {groups[g]:8.3f} ms/step {100 * groups[g] / wall_ms:5.1f}% of the step")
        kernels = sorted(((ms, n, k) for (gg, k), (ms, n) in rows.items() if gg == g),
                         reverse=True)
        for ms, n, k in kernels[:top]:
            print(f"      {ms / steps:8.3f} ms/step {n / steps:6.1f}x  {k[:100]}")
    if trace:
        prof.export_chrome_trace(trace)
    return {"wall_ms": wall_ms, "traced_ms": traced_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "groups_ms": groups}


def main(argv: list[str] | None = None) -> dict:
    from tpuflow_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="backward-step")
    ap.add_argument("--steps", type=int, default=16, help="rollout steps, untraced and traced")
    ap.add_argument("--top", type=int, default=15, help="kernels listed per group")
    ap.add_argument("--trace", default="", help="write the Chrome trace here")
    args = ap.parse_args(argv)
    return run(args.case, resolve_device("cuda"), args.steps, args.top, args.trace)


if __name__ == "__main__":
    main()
