"""Convert a trajectory archive (.h5/.hdf5/.npz) to the .tpf store.

Counterpart of ``tpuflow/tools/convert_tpf.py``. The .tpf store
(``tpuflow_torch/data/tpf.py``) holds page-aligned raw float32 arrays
that the native loader streams with the normalization fused into the
gather; ``data.loader=stream`` trains from it without loading the
split into RAM.

Usage: python -m tpuflow_torch.tools.convert_tpf in.h5 out.tpf
"""

from __future__ import annotations

import argparse
import sys

from tpuflow_torch.data.dataset import load_archive
from tpuflow_torch.data.tpf import save_tpf


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("src", help="input archive (.h5/.hdf5/.npz)")
    p.add_argument("dst", help="output store (.tpf)")
    a = p.parse_args(argv)
    if not a.dst.endswith(".tpf"):
        p.error("dst must end with .tpf")
    lf, hf = load_archive(a.src)
    save_tpf(a.dst, lf, hf)
    print(f"ok: {a.dst} lf={lf.shape} hf={hf.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
