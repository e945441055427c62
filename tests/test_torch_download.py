"""The port's downloads (``tpuflow_torch.data.download``) against a file
served by ``http.server`` on 127.0.0.1 in a thread; nothing is fetched
from outside. A checksum pass and a re-run that keeps the file, a
mismatch that raises and leaves no file, a retry after a dropped first
response, a failure after the last attempt, the ``sources.json`` lookup
with the archive contract checked, and the extension taken from a URL
with a query and a fragment."""

import hashlib
import http.server
import json
import threading

import numpy as np
import pytest

import tpuflow_torch.data.download as dl
from tpuflow_torch.data import save_archive


class _Server:
    """Serves ``files`` (name -> bytes); the first ``drops[name]`` requests
    for a name get a response whose body is cut short."""

    def __init__(self):
        self.files, self.drops, self.requests = {}, {}, []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                name = self.path.lstrip("/").split("?", 1)[0]
                outer.requests.append(name)
                body = outer.files.get(name)
                if body is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if outer.drops.get(name, 0) > 0:
                    outer.drops[name] -= 1
                    self.wfile.write(body[: len(body) // 2])
                    self.close_connection = True
                    return
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def url(self, name):
        return f"http://127.0.0.1:{self.httpd.server_address[1]}/{name}"


@pytest.fixture
def server(monkeypatch):
    monkeypatch.setattr(dl, "_RETRY_PAUSE_S", 0.0)
    s = _Server()
    s.thread.start()
    yield s
    s.httpd.shutdown()
    s.httpd.server_close()
    s.thread.join(timeout=10)


def _parts(d):
    return sorted(p.name for p in d.glob("*.part"))


def test_checksum_pass_and_rerun_keeps_the_file(server, tmp_path):
    payload = b"x" * 4096
    server.files["a.npz"] = payload
    good = hashlib.sha256(payload).hexdigest()
    dest = tmp_path / "out" / "a.npz"
    assert dl.download_file(server.url("a.npz"), dest, sha256=good) == dest
    assert dest.read_bytes() == payload and dl.sha256_file(dest) == good
    assert dl.download_file(server.url("a.npz"), dest, sha256=good.upper()) == dest
    assert server.requests == ["a.npz"]  # the re-run kept the verified file
    with pytest.raises(ValueError, match="exists but its sha256"):
        dl.download_file(server.url("a.npz"), dest, sha256="0" * 64)


def test_mismatch_raises_and_leaves_no_file(server, tmp_path):
    server.files["a.npz"] = b"y" * 1000
    dest = tmp_path / "b.npz"
    with pytest.raises(ValueError, match="sha256 mismatch"):
        dl.download_file(server.url("a.npz"), dest, sha256="0" * 64)
    assert not dest.exists() and _parts(tmp_path) == []


def test_retry_after_a_dropped_first_response(server, tmp_path):
    payload = bytes(range(256)) * 64
    server.files["a.npz"], server.drops["a.npz"] = payload, 1
    dest = tmp_path / "a.npz"
    dl.download_file(server.url("a.npz"), dest, sha256=hashlib.sha256(payload).hexdigest())
    assert dest.read_bytes() == payload and server.requests == ["a.npz", "a.npz"]
    assert _parts(tmp_path) == []


def test_every_attempt_failing_raises(server, tmp_path):
    server.files["a.npz"], server.drops["a.npz"] = b"z" * 512, dl._ATTEMPTS
    with pytest.raises(ConnectionError, match=f"after {dl._ATTEMPTS} attempts"):
        dl.download_file(server.url("a.npz"), tmp_path / "a.npz")
    assert len(server.requests) == dl._ATTEMPTS
    assert not (tmp_path / "a.npz").exists() and _parts(tmp_path) == []
    with pytest.raises(ConnectionError, match="404"):
        dl.download_file(server.url("missing.npz"), tmp_path / "m.npz")


def test_fetch_case_from_sources_json(server, tmp_path):
    lf = np.zeros((2, 3, 4, 8, 3), np.float32)
    hf = np.zeros((2, 3, 8, 16, 3), np.float32)
    hosted = tmp_path / "hosted.npz"
    save_archive(hosted, lf, hf)
    server.files["hosted.npz"] = hosted.read_bytes()
    bad = tmp_path / "bad.npz"
    np.savez(bad, lf=np.zeros((2, 5, 4, 8, 3)), hf=np.zeros((2, 3, 8, 16, 3)))
    server.files["bad.npz"] = bad.read_bytes()
    data_dir = tmp_path / "datasets"
    data_dir.mkdir()
    (data_dir / "sources.json").write_text(json.dumps({"backward-step": {"train": {
        "url": server.url("hosted.npz"), "sha256": dl.sha256_file(hosted)}}}))
    dest = dl.fetch_case("backward-step", data_dir, split="train")
    assert dest == data_dir / "backward-step_train.npz"
    assert dest.read_bytes() == hosted.read_bytes()
    with pytest.raises(LookupError, match="no registered source"):
        dl.fetch_case("backward-step", data_dir, split="test")
    with pytest.raises(ValueError, match="archive contract"):
        dl.fetch_case("cylinder-array", data_dir, url=server.url("bad.npz"))
    assert dl.main(["backward-step", "--data-dir", str(data_dir)]) == 0


def test_fetch_case_extension_and_shapes(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(dl, "download_file", lambda url, dest, sha256=None: seen.update(d=dest))
    monkeypatch.setattr(dl, "_validate_archive", lambda p: None)
    out = dl.fetch_case("backward-step", tmp_path,
                        url="http://127.0.0.1:1/files/data.h5?download=1#sha256=abcd")
    assert out.name == "backward-step_train.h5" == seen["d"].name
    with pytest.raises(ValueError, match="unsupported archive extension"):
        dl.fetch_case("backward-step", tmp_path, url="http://127.0.0.1:1/x.zip")
    lf = np.zeros((2, 3, 4, 8, 3), np.float32)
    hf = np.zeros((2, 3, 8, 16, 3), np.float32)
    for ext in (".h5", ".npz", ".tpf"):
        p = tmp_path / f"a{ext}"
        save_archive(p, lf, hf)
        assert dl._archive_shapes(p) == (lf.shape, hf.shape)
