"""Dataset download helpers: fetch a trajectory archive, check its SHA-256
and its (lf, hf) contract.

Counterpart of ``tpuflow/data/download.py``, standard library only. The
registry of sources ships empty: each entry is supplied by the user
(``--url``/``--sha256``, or a ``sources.json`` in the data directory).
A download streams to a temporary file beside its destination. A
transfer that fails is started again from scratch, up to ``_ATTEMPTS``
times in all (no partial-file resume); a checksum mismatch raises and
leaves no file; a re-run keeps a file whose checksum matches.

Usage:
    python -m tpuflow_torch.data.download backward-step --split train \\
        --url https://zenodo.org/record/<id>/files/<name>.h5 \\
        --sha256 <hex> --data-dir ./datasets

or register sources once in ``{data_dir}/sources.json``::

    {"backward-step": {"train": {"url": "...", "sha256": "..."}}}
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import pathlib
import shutil
import sys
import tempfile
import time
import urllib.error
import urllib.request

_CHUNK = 1 << 20
# Transfers per download before it fails, and the pause before each retry.
_ATTEMPTS = 3
_RETRY_PAUSE_S = 0.5

#: case -> split -> {"url": ..., "sha256": ...}. Empty: fill it through
#: sources.json or the CLI's flags (module docstring).
DATASET_SOURCES: dict[str, dict[str, dict[str, str]]] = {}


def sha256_file(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def _transfer(url: str, dest_dir: pathlib.Path, name: str) -> pathlib.Path:
    """Stream ``url`` into a new temporary file in ``dest_dir``; the file is
    removed if the transfer fails."""
    with tempfile.NamedTemporaryFile(dir=dest_dir, prefix=name + ".", suffix=".part",
                                     delete=False) as tmp:
        path = pathlib.Path(tmp.name)
        try:
            # The timeout makes a stalled connection fail, not hang.
            with urllib.request.urlopen(url, timeout=60) as resp:
                shutil.copyfileobj(resp, tmp, _CHUNK)
                # A body cut short ends reads quietly; its length tells.
                expected = resp.headers.get("Content-Length")
                if expected is not None and tmp.tell() != int(expected):
                    raise ConnectionError(
                        f"body cut short: {tmp.tell()} of {expected} bytes")
        except BaseException:
            tmp.close()
            path.unlink(missing_ok=True)
            raise
    return path


def download_file(
    url: str,
    dest: str | pathlib.Path,
    sha256: str | None = None,
    overwrite: bool = False,
) -> pathlib.Path:
    """Stream ``url`` to ``dest`` and verify its SHA-256.

    An existing file is kept if its checksum matches (idempotent re-runs).
    A transfer that fails (connection, HTTP error, a body shorter than
    its ``Content-Length``) is retried from scratch; after the last
    attempt it raises ``ConnectionError``. A checksum mismatch on a fresh download raises
    ``ValueError`` and removes the file.
    """
    dest = pathlib.Path(dest)
    if dest.exists() and not overwrite:
        if sha256 is None or sha256_file(dest) == sha256.lower():
            return dest
        raise ValueError(
            f"{dest} exists but its sha256 does not match; pass overwrite=True to re-download"
        )
    dest.parent.mkdir(parents=True, exist_ok=True)
    for attempt in range(1, _ATTEMPTS + 1):
        try:
            # http.client.HTTPException (not an OSError) covers a
            # malformed response.
            tmp = _transfer(url, dest.parent, dest.name)
            break
        except (urllib.error.URLError, OSError, http.client.HTTPException) as e:
            if attempt == _ATTEMPTS:
                raise ConnectionError(
                    f"download failed for {url} after {_ATTEMPTS} attempts: {e}. Without "
                    "network access, use data.synthetic=true for the procedural fixture or "
                    "place the archives by hand"
                ) from e
            time.sleep(_RETRY_PAUSE_S)
    try:
        if sha256 is not None:
            got = sha256_file(tmp)
            if got != sha256.lower():
                raise ValueError(f"sha256 mismatch for {url}: expected {sha256}, got {got}")
        tmp.replace(dest)
    finally:
        tmp.unlink(missing_ok=True)
    return dest


def _load_sources(data_dir: pathlib.Path) -> dict:
    """DATASET_SOURCES merged with ``{data_dir}/sources.json`` (the file wins)."""
    merged = {c: dict(s) for c, s in DATASET_SOURCES.items()}
    p = data_dir / "sources.json"
    if p.exists():
        for case, splits in json.loads(p.read_text()).items():
            merged.setdefault(case, {}).update(splits)
    return merged


def fetch_case(
    case: str,
    data_dir: str | pathlib.Path = "./datasets",
    split: str = "train",
    url: str | None = None,
    sha256: str | None = None,
) -> pathlib.Path:
    """Fetch one (case, split) archive to the loader's path
    ``{data_dir}/{case}_{split}{ext}`` and validate its contract."""
    data_dir = pathlib.Path(data_dir)
    if url is None:
        src = _load_sources(data_dir).get(case, {}).get(split)
        if not src or not src.get("url"):
            raise LookupError(
                f"no registered source for ({case!r}, {split!r}); pass --url (and "
                f"--sha256), or add it to {data_dir / 'sources.json'}"
            )
        url, sha256 = src["url"], src.get("sha256", sha256)
    # Strip the query and the fragment (the '#sha256=...' convention)
    # before taking the extension.
    ext = pathlib.Path(url.split("?", 1)[0].split("#", 1)[0]).suffix or ".h5"
    if ext not in (".h5", ".hdf5", ".npz"):
        raise ValueError(f"unsupported archive extension {ext!r} in {url}")
    dest = data_dir / f"{case}_{split}{ext}"
    download_file(url, dest, sha256=sha256)
    _validate_archive(dest)
    return dest


def _archive_shapes(path: pathlib.Path) -> tuple[tuple, tuple]:
    """(lf_shape, hf_shape) without loading the arrays: h5py reads dataset
    shapes from metadata, and each .npy header inside an .npz carries its
    shape."""
    suffix = path.suffix.lower()
    if suffix in (".h5", ".hdf5"):
        import h5py

        with h5py.File(path, "r") as f:
            return tuple(f["lf"].shape), tuple(f["hf"].shape)
    if suffix == ".npz":
        import zipfile

        import numpy.lib.format as npy_format

        shapes = {}
        with zipfile.ZipFile(path) as z:
            for name in ("lf", "hf"):
                with z.open(name + ".npy") as f:
                    version = npy_format.read_magic(f)
                    if version == (1, 0):
                        shape, _, _ = npy_format.read_array_header_1_0(f)
                    else:
                        shape, _, _ = npy_format.read_array_header_2_0(f)
                    shapes[name] = tuple(shape)
        return shapes["lf"], shapes["hf"]
    from tpuflow_torch.data.dataset import load_archive  # another suffix: a full load

    lf, hf = load_archive(path)
    return lf.shape, hf.shape


def _validate_archive(path: pathlib.Path) -> None:
    """The archive contract: datasets ``lf``/``hf``, 5-D, aligned (N, T)."""
    lf_shape, hf_shape = _archive_shapes(path)
    if len(lf_shape) != 5 or len(hf_shape) != 5 or lf_shape[:2] != hf_shape[:2]:
        raise ValueError(
            f"{path} violates the archive contract: lf {lf_shape}, hf {hf_shape} "
            "(want aligned 5-D (N, T, h, w, C))"
        )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("case", help="backward-step | cylinder-array | ...")
    p.add_argument("--split", default="train", help="train | test")
    p.add_argument("--url", default=None)
    p.add_argument("--sha256", default=None)
    p.add_argument("--data-dir", default="./datasets")
    a = p.parse_args(argv)
    dest = fetch_case(a.case, a.data_dir, split=a.split, url=a.url, sha256=a.sha256)
    print(f"ok: {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
