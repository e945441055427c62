"""Archive inspector: summarize and contract-check a trajectory archive.

Counterpart of ``tpuflow/tools/inspect_data.py``, with the same checks,
``--import`` heuristics and ``--json`` keys. Run it first on a newly
obtained archive: it prints what the file holds and which clause of the
contract fails, instead of a stack trace three layers into training.

Usage:
  python -m tpuflow_torch.tools.inspect_data <archive.{h5|hdf5|npz|tpf}>
      [--n-scales=3] [--json]
  python -m tpuflow_torch.tools.inspect_data --import <alien.{h5|hdf5|npz}>
      --out <case_split.{h5|npz|tpf}> [--json]

``--import`` ingests an archive with unknown key names and layouts by
heuristic matching: it walks every dataset in the file, canonicalizes
each plausible trajectory array to (N, T, H, W, C) (channel-first
layouts and single-trajectory 4-D arrays included), pairs the low- and
high-fidelity arrays by aligned (N, T, C), grid refinement and name
hints (lf/low/coarse against hf/high/fine/dns), and writes a conforming
archive with ``save_archive``. Every inference is printed, so a wrong
guess shows before training on it.

Checks:
  - datasets lf/hf, 5-D (N, T, h, w, C), aligned (N, T), C == 3
  - H, W divisible by 2**n_scales (the Glow's squeezes)
  - finite values (NaN/Inf counts per field)
It reports per-channel physical statistics and the per-channel LF<->HF
correlation on HF pooled to the LF grid (the synthetic fixtures sit
above 0.9; a value near zero usually means mis-paired or mis-ordered
datasets).
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

_CHANNELS = ("u", "v", "p")


def _pool_to(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Mean-pool (..., H, W, C) onto an (h, w) grid for LF comparison."""
    H, W = a.shape[-3], a.shape[-2]
    if H % h or W % w:  # fall back to stride sampling on ragged ratios
        return a[..., :: max(H // h, 1), :: max(W // w, 1), :][..., :h, :w, :]
    return a.reshape(*a.shape[:-3], h, H // h, w, W // w, a.shape[-1]).mean(
        axis=(-4, -2)
    )


def inspect_archive(path: str | pathlib.Path, n_scales: int = 3) -> dict:
    """Return the inspection record (also the --json output)."""
    from tpuflow_torch.data.dataset import load_archive

    path = pathlib.Path(path)
    lf, hf = load_archive(path)
    rec: dict = {
        "path": str(path),
        "lf_shape": list(lf.shape),
        "hf_shape": list(hf.shape),
        "dtype": {"lf": str(lf.dtype), "hf": str(hf.dtype)},
        "errors": [],
        "warnings": [],
    }

    if lf.ndim != 5 or hf.ndim != 5:
        rec["errors"].append(
            f"lf/hf must be 5-D (N, T, h, w, C); got lf {lf.shape}, hf {hf.shape}"
        )
        rec["ok"] = False
        return rec
    if lf.size == 0 or hf.size == 0:
        rec["errors"].append(
            f"empty archive: lf {lf.shape}, hf {hf.shape} contain no data"
        )
        rec["ok"] = False
        return rec
    if lf.shape[:2] != hf.shape[:2]:
        rec["errors"].append(
            f"(N, T) misaligned: lf {lf.shape[:2]} vs hf {hf.shape[:2]}"
        )
    if lf.shape[-1] != hf.shape[-1]:
        rec["errors"].append(
            f"channel mismatch: lf C={lf.shape[-1]} vs hf C={hf.shape[-1]}"
        )
    if hf.shape[-1] != len(_CHANNELS):
        rec["warnings"].append(
            f"C={hf.shape[-1]} (contract orders channels (u, v, p); C=3)"
        )
    H, W = hf.shape[2], hf.shape[3]
    div = 2**n_scales
    if H % div or W % div:
        rec["errors"].append(
            f"HF grid {H}x{W} not divisible by 2**n_scales={div} "
            f"(Glow squeeze wiring)"
        )

    for name, a in (("lf", lf), ("hf", hf)):
        bad = int(np.size(a) - np.isfinite(a).sum())
        if bad:
            rec["errors"].append(f"{name} has {bad} non-finite values")
        rec[f"{name}_channels"] = {
            (_CHANNELS[c] if c < len(_CHANNELS) else f"c{c}"): {
                "mean": float(a[..., c].mean()),
                "std": float(a[..., c].std()),
                "min": float(a[..., c].min()),
                "max": float(a[..., c].max()),
            }
            for c in range(a.shape[-1])
        }

    # LF<->HF pairing sanity: pooled-HF vs LF per-channel correlation.
    if hf.shape[2] < lf.shape[2] or hf.shape[3] < lf.shape[3]:
        rec["warnings"].append(
            f"HF grid {hf.shape[2]}x{hf.shape[3]} is SMALLER than the LF "
            f"grid {lf.shape[2]}x{lf.shape[3]} — lf/hf datasets are likely "
            "swapped (contract: hf is the fine grid)"
        )
    elif not rec["errors"]:
        pooled = _pool_to(hf, lf.shape[2], lf.shape[3])
        corr = {}
        for c in range(lf.shape[-1]):
            x = lf[..., c].ravel().astype(np.float64)
            y = pooled[..., c].ravel().astype(np.float64)
            sx, sy = x.std(), y.std()
            corr[_CHANNELS[c] if c < len(_CHANNELS) else f"c{c}"] = (
                float(((x - x.mean()) * (y - y.mean())).mean() / (sx * sy))
                if sx > 0 and sy > 0
                else 0.0
            )
        rec["lf_hf_correlation"] = corr
        if max(corr.values()) < 0.2:
            rec["warnings"].append(
                "LF<->HF correlation near zero on every channel — datasets "
                "may be mis-paired or channel order may differ from (u, v, p)"
            )

    rec["ok"] = not rec["errors"]
    return rec


_LF_HINTS = ("lf", "low", "coarse", "input", "lores", "cheap")
_HF_HINTS = ("hf", "high", "fine", "target", "truth", "dns", "hires", "ref")
_MAX_CHANNELS = 8  # trajectory fields carry a handful of channels (u,v,p,...)


def _collect_datasets(path: pathlib.Path) -> dict[str, np.ndarray]:
    """All array leaves in an .h5/.hdf5 (recursive) or .npz file."""
    out: dict[str, np.ndarray] = {}
    if path.suffix in (".h5", ".hdf5"):
        import h5py

        with h5py.File(path, "r") as f:
            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    out[name] = np.asarray(obj)
            f.visititems(visit)
    elif path.suffix == ".npz":
        with np.load(path) as f:
            out.update({k: f[k] for k in f.files})
    else:
        raise ValueError(f"--import reads .h5/.hdf5/.npz, got {path.suffix}")
    return out


def _canonicalize(a: np.ndarray) -> tuple[np.ndarray, str] | None:
    """Best-effort mapping of an array onto (N, T, H, W, C).

    Handles: 5-D channels-last (N,T,H,W,C); 5-D channel-first
    (N,T,C,H,W) (torch convention); 4-D single-trajectory (T,H,W,C) or
    (T,C,H,W) -> N=1. Returns (array, note) or None if the array can't
    plausibly be a trajectory field stack.
    """
    if not np.issubdtype(a.dtype, np.number):
        return None

    def ch_last_ok(c, s1, s2):
        # The channel axis is the small one: <= _MAX_CHANNELS and no
        # larger than either spatial dim (grids can be as small as the
        # channel budget, so <= not <).
        return c <= _MAX_CHANNELS and c <= min(s1, s2)

    if a.ndim == 4:
        t, d1, d2, d3 = a.shape
        if ch_last_ok(d3, d1, d2) and (not ch_last_ok(d1, d2, d3) or d3 <= d1):
            return a[None], "4-D (T,H,W,C): added N=1"
        if ch_last_ok(d1, d2, d3):
            return np.moveaxis(a, 1, -1)[None], (
                "4-D channel-first (T,C,H,W): moved C last, added N=1"
            )
        return None
    if a.ndim == 5:
        d2, d3, d4 = a.shape[2:]
        if ch_last_ok(d4, d2, d3) and (not ch_last_ok(d2, d3, d4) or d4 <= d2):
            return a, "5-D (N,T,H,W,C): as-is"
        if ch_last_ok(d2, d3, d4):
            return np.moveaxis(a, 2, -1), (
                "5-D channel-first (N,T,C,H,W): moved C last"
            )
    return None


def _name_score(name: str, hints: tuple[str, ...]) -> int:
    low = name.lower()
    return max((len(h) for h in hints if h in low), default=0)


def import_alien(
    src: str | pathlib.Path, out: str | pathlib.Path, n_scales: int = 3
) -> dict:
    """Heuristically ingest an unknown-layout archive; returns the
    decision record (keys chosen, layout notes, final shapes)."""
    from tpuflow_torch.data.dataset import save_archive

    src = pathlib.Path(src)
    raw = _collect_datasets(src)
    cands: dict[str, tuple[np.ndarray, str]] = {}
    for name, a in raw.items():
        c = _canonicalize(a)
        if c is not None:
            cands[name] = c
    if len(cands) < 2:
        raise ValueError(
            f"{src}: found {len(cands)} plausible trajectory arrays "
            f"(need an LF/HF pair); datasets seen: "
            f"{ {k: list(v.shape) for k, v in raw.items()} }"
        )

    # Pair candidates: aligned (N, T, C), HF grid strictly finer; rank
    # by name hints, then by grid refinement ratio.
    best = None
    names = sorted(cands)
    for i in names:
        for j in names:
            if i == j:
                continue
            a, _ = cands[i]  # lf candidate
            b, _ = cands[j]  # hf candidate
            if a.shape[:2] != b.shape[:2] or a.shape[-1] != b.shape[-1]:
                continue
            if not (b.shape[2] > a.shape[2] and b.shape[3] > a.shape[3]):
                continue
            ratio = (b.shape[2] / a.shape[2]) * (b.shape[3] / a.shape[3])
            score = (
                _name_score(i, _LF_HINTS) + _name_score(j, _HF_HINTS),
                ratio,
            )
            if best is None or score > best[0]:
                best = (score, i, j)
    if best is None:
        raise ValueError(
            f"{src}: no (LF, HF) pair with aligned (N, T, C) and a finer "
            f"HF grid among candidates "
            f"{ {k: list(v[0].shape) for k, v in cands.items()} }"
        )
    _, lf_key, hf_key = best
    lf, lf_note = cands[lf_key]
    hf, hf_note = cands[hf_key]

    out = pathlib.Path(out)
    save_archive(out, lf.astype(np.float32), hf.astype(np.float32))
    rec = {
        "source": str(src),
        "out": str(out),
        "lf_key": lf_key,
        "hf_key": hf_key,
        "lf_layout": lf_note,
        "hf_layout": hf_note,
        "lf_shape": list(lf.shape),
        "hf_shape": list(hf.shape),
        "skipped_keys": sorted(set(raw) - {lf_key, hf_key}),
    }
    # Validate the written archive against the normal contract.
    rec["inspection"] = inspect_archive(out, n_scales=n_scales)
    rec["ok"] = rec["inspection"]["ok"]
    return rec


def _fmt(rec: dict) -> str:
    lines = [f"archive: {rec['path']}"]
    lines.append(
        f"  lf {tuple(rec['lf_shape'])} {rec['dtype']['lf']}   "
        f"hf {tuple(rec['hf_shape'])} {rec['dtype']['hf']}"
    )
    for name in ("lf", "hf"):
        ch = rec.get(f"{name}_channels")
        if ch:
            for cname, s in ch.items():
                lines.append(
                    f"  {name}.{cname}: mean {s['mean']:+.4g}  std {s['std']:.4g}"
                    f"  range [{s['min']:.4g}, {s['max']:.4g}]"
                )
    if "lf_hf_correlation" in rec:
        c = rec["lf_hf_correlation"]
        lines.append(
            "  lf<->hf corr: "
            + "  ".join(f"{k}={v:+.3f}" for k, v in c.items())
        )
    for w in rec["warnings"]:
        lines.append(f"  WARNING: {w}")
    for e in rec["errors"]:
        lines.append(f"  ERROR: {e}")
    lines.append("  contract: " + ("OK" if rec["ok"] else "VIOLATED"))
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_scales, as_json, paths = 3, False, []
    import_src, out_path = None, None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--n-scales="):
            n_scales = int(a.split("=", 1)[1])
        elif a == "--json":
            as_json = True
        elif a == "--import":
            i += 1
            import_src = argv[i]
        elif a.startswith("--import="):
            import_src = a.split("=", 1)[1]
        elif a == "--out":
            i += 1
            out_path = argv[i]
        elif a.startswith("--out="):
            out_path = a.split("=", 1)[1]
        elif a.startswith("--"):
            raise SystemExit(f"unknown flag {a}")
        else:
            paths.append(a)
        i += 1

    if import_src is not None:
        if out_path is None:
            raise SystemExit("--import requires --out <archive path>")
        rec = import_alien(import_src, out_path, n_scales=n_scales)
        if as_json:
            print(json.dumps(rec))
        else:
            print(
                f"imported {rec['source']} -> {rec['out']}\n"
                f"  lf <- {rec['lf_key']}  ({rec['lf_layout']}) "
                f"{tuple(rec['lf_shape'])}\n"
                f"  hf <- {rec['hf_key']}  ({rec['hf_layout']}) "
                f"{tuple(rec['hf_shape'])}\n"
                f"  skipped: {rec['skipped_keys']}\n"
                + _fmt(rec["inspection"])
            )
        return 0 if rec["ok"] else 1

    if not paths:
        print(__doc__)
        return 2
    ok = True
    for p in paths:
        rec = inspect_archive(p, n_scales=n_scales)
        print(json.dumps(rec) if as_json else _fmt(rec))
        ok = ok and rec["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
