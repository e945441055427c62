"""Serve an exported rollout artifact: batch files or an HTTP endpoint.

Counterpart of ``tpuflow/tools/serve.py``, with its contract: the server
needs only the artifact (``tools/export_rollout.py``) and its sidecar
``rollout.meta.json``, no model code and no checkpoint, and requests
arrive in physical units (the sidecar carries the LF normalization).

Two modes:

  batch  - one-shot file -> file:
      python -m tpuflow_torch.tools.serve batch --artifact rollout.torchexport \\
          --input lf.npz --output stats.npz [--seed 0] [--temperature t] \\
          [--normalized] [--calibrated] [--device cuda|cpu]
      Input: .npz with array "lf" (or a single unnamed array / .npy) of
      shape (T, h, w, C) in physical units (pass --normalized if it is
      already normalized). Output: .npz with physical-unit "mean" and
      "var" of shape (T, H, W, C).

  http   - stdlib ThreadingHTTPServer:
      python -m tpuflow_torch.tools.serve http --artifact rollout.torchexport \\
          [--host 127.0.0.1] [--port 8421] [--device cuda|cpu]
      POST /rollout?seed=0&temperature=0.7[&normalized=1][&calibrated=1]
      with an .npz body -> .npz response ("mean", "var"). GET /healthz ->
      the sidecar's JSON. A bad payload or a contract violation answers
      400, a fault while computing 500; the server keeps serving. Calls
      are serialized through one lock: one card, one program.

``examples/serve_client.py`` (numpy and urllib only) is a client of
either package's server.

``--calibrated`` / ``?calibrated=1`` scales the variance by the sidecar's
``spread_scale`` squared (the case was evaluated before export).

``--device`` defaults to ``cuda`` and raises where there is no GPU; name
``cpu`` to serve there. The artifact serves only on the device it was
exported on, with the same torch major.minor (``tools/artifact.py``).
"""

from __future__ import annotations

import argparse
import io
import json
import pathlib
import threading

import numpy as np


class RolloutServer:
    """A loaded artifact + sidecar, exposing physical-unit rollout."""

    def __init__(self, artifact_path: str | pathlib.Path, meta_path=None, device="cuda"):
        # Leaf imports: the serving host needs torch + numpy only, not the
        # model/data/training stack (tools/artifact.py docstring).
        from tpuflow_torch.device import resolve_device
        from tpuflow_torch.tools.artifact import load_artifact

        artifact_path = pathlib.Path(artifact_path)
        self.fn = load_artifact(artifact_path, resolve_device(device))
        meta_path = (pathlib.Path(meta_path) if meta_path
                     else artifact_path.with_suffix(".meta.json"))
        if not meta_path.exists():
            raise FileNotFoundError(
                f"sidecar {meta_path} not found: re-run tools/export_rollout.py (it writes "
                "rollout.meta.json next to the artifact) or pass --meta explicitly")
        self.meta = json.loads(meta_path.read_text())
        self._lf_mean = np.asarray(self.meta["lf_mean"], dtype=np.float32)
        self._lf_std = np.asarray(self.meta["lf_std"], dtype=np.float32)
        self._lock = threading.Lock()

    def rollout(self, lf, seed=0, temperature=None, normalized=False, calibrated=False):
        """Physical-unit LF trajectory -> {"mean", "var"} numpy dict.

        ``calibrated=True`` also applies the sidecar's fitted spread
        inflation (var * spread_scale^2); raises ValueError if the artifact
        was exported before the case was evaluated.
        """
        lf = np.asarray(lf, dtype=np.float32)
        want = tuple(self.meta["lf_input_shape"])
        if lf.shape != want:
            raise ValueError(
                f"LF input shape {lf.shape} != exported contract {want} "
                "(the artifact is exported for a fixed trajectory shape)")
        if not normalized:
            lf = (lf - self._lf_mean) / self._lf_std
        tau = self.meta["default_temperature"] if temperature is None else temperature
        # Wrap, don't reject: any int is a seed.
        seed = int(seed) % (1 << 32)
        if calibrated and "spread_scale" not in self.meta:
            raise ValueError(
                "calibrated rollout requested but the sidecar carries no spread_scale: "
                "evaluate the case, then re-export (the exporter picks the fitted factors "
                "up from eval_metrics.json)")
        tau_v = np.asarray(tau, np.float32).reshape(-1)
        if tau_v.size == 1:
            tau_v = np.full((int(self.meta["n_scales"]),), tau_v[0], np.float32)
        with self._lock:
            out = self.fn(lf, seed, tau_v)
            out = {k: v.cpu().numpy() for k, v in out.items()}
        if calibrated:
            out["var"] = out["var"] * np.float32(self.meta["spread_scale"]) ** 2
        return out


def _read_lf(data: bytes) -> np.ndarray:
    """Decode an .npz (array "lf" or the single array) or .npy payload
    (np.load detects which from the magic bytes)."""
    loaded = np.load(io.BytesIO(data), allow_pickle=False)
    if isinstance(loaded, np.ndarray):  # .npy content
        return loaded
    with loaded:
        if "lf" in loaded.files:
            return loaded["lf"]
        if len(loaded.files) == 1:
            return loaded[loaded.files[0]]
        raise ValueError(f"ambiguous npz payload {loaded.files}: name the array 'lf'")


def _pack_npz(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def run_batch(args) -> pathlib.Path:
    server = RolloutServer(args.artifact, args.meta, args.device)
    lf = _read_lf(pathlib.Path(args.input).read_bytes())
    out = server.rollout(lf, seed=args.seed, temperature=args.temperature,
                         normalized=args.normalized, calibrated=args.calibrated)
    out_path = pathlib.Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_bytes(_pack_npz(out))
    print(f"rollout {server.meta['rollout_steps']} steps x {server.meta['n_samples']} members "
          f"-> {out_path} (mean/var {out['mean'].shape})")
    return out_path


def make_http_server(server: RolloutServer, host: str, port: int):
    """Build (not start) the HTTP server."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):  # quiet by default
            pass

        def do_GET(self):
            if self.path.split("?")[0] == "/healthz":
                self._send(200, json.dumps(server.meta).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/rollout":
                self._send(404, b"not found", "text/plain")
                return
            q = parse_qs(parsed.query)
            try:
                n = int(self.headers.get("Content-Length", 0))
                lf = _read_lf(self.rfile.read(n))
            except Exception as e:  # undecodable payload = client error
                self._send(400, str(e).encode(), "text/plain")
                return
            try:
                out = server.rollout(
                    lf,
                    seed=int(q.get("seed", ["0"])[0]),
                    temperature=(float(q["temperature"][0]) if "temperature" in q else None),
                    normalized=q.get("normalized", ["0"])[0] in ("1", "true"),
                    calibrated=q.get("calibrated", ["0"])[0] in ("1", "true"),
                )
            except ValueError as e:  # contract violation = client error
                self._send(400, str(e).encode(), "text/plain")
                return
            except Exception as e:  # runtime fault = server error; keep serving
                self._send(500, str(e).encode(), "text/plain")
                return
            self._send(200, _pack_npz(out), "application/octet-stream")

    return ThreadingHTTPServer((host, port), Handler)


def run_http(args):
    server = RolloutServer(args.artifact, args.meta, args.device)
    httpd = make_http_server(server, args.host, args.port)
    print(f"serving {server.meta['case']} rollout on "
          f"http://{args.host}:{httpd.server_address[1]} (POST /rollout, GET /healthz)")
    httpd.serve_forever()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpuflow-torch-serve", description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)

    def common(sp):
        sp.add_argument("--artifact", required=True)
        sp.add_argument("--meta", default=None)
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    b = sub.add_parser("batch", help="one-shot file -> file rollout")
    common(b)
    b.add_argument("--input", required=True)
    b.add_argument("--output", required=True)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--temperature", type=float, default=None)
    b.add_argument("--normalized", action="store_true",
                   help="input is already normalized (skip the sidecar constants)")
    b.add_argument("--calibrated", action="store_true",
                   help="apply the sidecar's fitted UQ recalibration (var x spread_scale^2)")

    h = sub.add_parser("http", help="HTTP rollout endpoint")
    common(h)
    h.add_argument("--host", default="127.0.0.1")
    h.add_argument("--port", type=int, default=8421)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mode == "batch":
        run_batch(args)
    else:
        run_http(args)


if __name__ == "__main__":
    main()
