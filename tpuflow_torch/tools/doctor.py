"""Environment doctor: is this machine ready to train and serve with the port?

Counterpart of ``tpuflow/tools/doctor.py``. Every check but the imports
runs in a subprocess with a timeout, so a hung driver, compiler or
collective yields a FAIL line instead of hanging the doctor.

Usage:
  python -m tpuflow_torch.tools.doctor [--probe-timeout=110] [--json]

Checks (the subprocesses run side by side):
  imports   tpuflow_torch, torch and numpy importable, versions
  device    a CUDA device visible: count, name, and the power limit
            nvidia-smi reports (a card below its maximum runs slower)
  kernel    nvcc found, K2 (the fused coupling) built, launched on a tiny
            input through its registered operator at f32 and bf16, and
            held against its plain version
  cpu       a tiny model's NLL step on the CPU
  mesh      a gloo all-reduce between two processes on the CPU
            (torch.distributed, a free local port)
  native    the .tpf loader built with g++, or the NumPy memmap path
  optional  h5py / matplotlib / tensorboard availability

Exit 0 if every required check passed. The checks that need the GPU
(device, kernel) are WARN-only, as the JAX doctor's device check: CPU
work is still possible without one. So are native and optional.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_ROOT = pathlib.Path(__file__).resolve().parents[2]  # holds tpuflow_torch/

_DEVICE = """
import subprocess, torch
if not torch.cuda.is_available():
    raise SystemExit('torch.cuda.is_available() is False')
try:
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
except Exception as e:
    smi = f'nvidia-smi not read: {e}'
print(f'{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}')
"""

_KERNEL = """
import torch
from tpuflow_torch.device import resolve_device
from tpuflow_torch.kernels import _build, ops
from tpuflow_torch.kernels.coupling_fused import fused_coupling_reference, pack_net
nvcc = _build.find_nvcc()
# resolve_device turns TF32 off: the f32 plain version's convs are full f32.
dev, g = resolve_device('cuda'), torch.Generator().manual_seed(0)
b, h, w, ca, width, growth, layers = 2, 4, 8, 6, 16, 8, 2
total0 = layers * growth + 2 * ca
rand = lambda *s: torch.randn(*s, generator=g).to(dev)
wjs = [0.1 * rand(total0 - j * growth, width if j == 0 else growth, 3, 3)
       for j in range(layers + 1)]
errs = []
for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-3)):
    net = pack_net(0.1 * rand(width, ca, 3, 3), rand(width), wjs, rand(total0), dtype)
    xa, xb, h0c = rand(b, h, w, ca), rand(b, h, w, ca), rand(1, h, w, width).to(dtype)
    y, ld = ops.fused_coupling(xa, xb, h0c, net, reverse=True)
    y_ref, _ = fused_coupling_reference(xa, xb, h0c, net, reverse=True)
    err = (y - y_ref).abs().max().item()
    if not err <= tol:
        raise SystemExit(f'K2 {dtype} against its plain version: {err:.3e} > {tol}')
    errs.append(err)
print(f'K2 built ({nvcc}), launched and held against its plain version: '
      f'y err {errs[0]:.1e} (f32), {errs[1]:.1e} (bf16)')
"""

_CPU = """
import math, torch
from tpuflow_torch.configs import load_case
from tpuflow_torch.models import TMGlow, init_lstm_state
cfg = load_case('backward-step', {'model.n_scales': 2, 'model.n_flow_steps': 1,
                'model.coupling_width': 8, 'model.coupling_layers': 1,
                'model.growth_rate': 4, 'model.encoder_width': 8, 'model.lstm_hidden': 8,
                'model.cond_channels': 8, 'model.hf_shape': (16, 32),
                'model.lf_shape': (4, 8), 'model.compute_dtype': 'float32'}).model
model = TMGlow(cfg, device='cpu')
g = torch.Generator().manual_seed(0)
hf, lf = torch.randn(1, 16, 32, 3, generator=g), torch.randn(1, 4, 8, 3, generator=g)
with torch.no_grad():
    bpd, _ = model.nll_step(hf, lf, init_lstm_state(cfg, 1, 'cpu'))
if not math.isfinite(bpd.item()):
    raise SystemExit(f'tiny NLL step not finite: {bpd.item()}')
print(f'tiny NLL step executed ({bpd.item():.3f} bits/dim)')
"""

# One rank of the two-process all-reduce; TPF_DOCTOR_RANK and
# TPF_DOCTOR_PORT come from _mesh.
_MESH_RANK = """
import os, torch, torch.distributed as dist
rank = int(os.environ['TPF_DOCTOR_RANK'])
dist.init_process_group('gloo', init_method=f"tcp://127.0.0.1:{os.environ['TPF_DOCTOR_PORT']}",
                        world_size=2, rank=rank)
t = torch.tensor([rank + 1.0])
dist.all_reduce(t)
dist.destroy_process_group()
if t.item() != 3.0:
    raise SystemExit(f'rank {rank}: all-reduce gave {t.item()}, not 3')
print('two-process gloo all-reduce executed')
"""

_NATIVE = """
from tpuflow_torch.data.tpf import _build_lib
lib = _build_lib()
print('native loader built' if lib is not None else 'memmap fallback (g++ unavailable)')
"""


def _sub(code: str, timeout: float, env_extra: dict | None = None) -> tuple[bool, str]:
    """Run ``python -c code`` in a subprocess that finds tpuflow_torch;
    (ok, last stdout line or the error)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(_ROOT), env.get("PYTHONPATH"))))
    env.update(env_extra or {})
    try:
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return False, f"timed out after {timeout:.0f}s"
    if out.returncode != 0:
        err = (out.stderr or "").strip().splitlines()
        return False, err[-1] if err else f"exit {out.returncode}"
    lines = (out.stdout or "").strip().splitlines()
    return True, lines[-1] if lines else ""


def _mesh(timeout: float) -> tuple[bool, str]:
    """Two ``_MESH_RANK`` subprocesses side by side on a free local port."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with ThreadPoolExecutor(2) as pool:
        ranks = [pool.submit(_sub, _MESH_RANK, timeout,
                             {"TPF_DOCTOR_RANK": str(r), "TPF_DOCTOR_PORT": str(port)})
                 for r in range(2)]
        results = [r.result() for r in ranks]
    return next((res for res in results if not res[0]), results[0])


def run_checks(probe_timeout: float = 110.0) -> dict:
    checks: dict[str, dict] = {}

    def record(name, ok, detail, required=True):
        checks[name] = {"ok": bool(ok), "detail": str(detail), "required": required}

    # In-process: cheap, and touches no device.
    try:
        import numpy
        import torch

        import tpuflow_torch  # noqa: F401

        record("imports", True, f"tpuflow_torch, torch {torch.__version__} "
               f"(CUDA {torch.version.cuda}), numpy {numpy.__version__}")
    except Exception as e:
        record("imports", False, f"{type(e).__name__}: {e}")
        return {"checks": checks, "ok": False}

    subprocess_checks = (
        ("device", lambda: _sub(_DEVICE, probe_timeout), False),
        ("kernel", lambda: _sub(_KERNEL, 600.0), False),  # a cold nvcc build takes seconds
        ("cpu", lambda: _sub(_CPU, 240.0), True),
        ("mesh", lambda: _mesh(240.0), True),
        ("native", lambda: _sub(_NATIVE, 240.0), False),
    )
    # The subprocesses run side by side: each spends seconds importing torch.
    with ThreadPoolExecutor(len(subprocess_checks)) as pool:
        results = [pool.submit(check) for _, check, _ in subprocess_checks]
        for (name, _, required), res in zip(subprocess_checks, results):
            record(name, *res.result(), required=required)

    opt = [f"{mod} ok" if importlib.util.find_spec(mod) is not None
           else f"{mod} MISSING ({why} unavailable)"
           for mod, why in (("h5py", ".h5 archives"), ("matplotlib", "figures"),
                            ("tensorboard", "TensorBoard logging"))]
    record("optional", True, "; ".join(opt), required=False)

    return {"checks": checks, "ok": all(c["ok"] for c in checks.values() if c["required"])}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    probe_timeout, as_json = 110.0, False
    for a in argv:
        if a.startswith("--probe-timeout="):
            probe_timeout = float(a.split("=", 1)[1])
        elif a == "--json":
            as_json = True
        elif a.startswith("--"):
            raise SystemExit(f"unknown flag {a}")
    result = run_checks(probe_timeout=probe_timeout)
    if as_json:
        print(json.dumps(result))
    else:
        for name, c in result["checks"].items():
            status = "PASS" if c["ok"] else ("WARN" if not c["required"] else "FAIL")
            print(f"{status:4s} {name:9s} {c['detail']}")
        print("doctor:", "healthy" if result["ok"] else "NOT healthy")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
