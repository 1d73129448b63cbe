"""The port's bounded child-process probe of the card
(``utils/backend_probe.py``), with tests/test_backend_probe.py's cases: the
probe's child interpreter is swapped for stub scripts (healthy, failing,
hanging, memoized), so no test starts CUDA. The real child's own answer on
a machine without a card is the last case: it fails, naming what it
lacked."""

import stat
import sys
import time

import torch

from tfservingcache_tpu_torch.utils import backend_probe


def _stub(tmp_path, body: str) -> str:
    p = tmp_path / "fake_python"
    p.write_text(f"#!{sys.executable}\nimport sys\n{body}\n")
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return str(p)


def test_healthy_child_answers(tmp_path, monkeypatch):
    exe = _stub(tmp_path, "print('ok gpu 1 NVIDIA H100 80GB HBM3')")
    monkeypatch.setattr(backend_probe.sys, "executable", exe)
    ok, diag = backend_probe.backend_answers(timeout_s=30.0, retries=0)
    assert ok and diag == "ok gpu 1 NVIDIA H100 80GB HBM3"


def test_failing_child_reports_stderr_and_retries(tmp_path, monkeypatch):
    marks = tmp_path / "attempts"
    exe = _stub(tmp_path, "open(r'%s', 'a').write('x')\n"
                          "sys.stderr.write('cuda init exploded')\nsys.exit(1)" % marks)
    monkeypatch.setattr(backend_probe.sys, "executable", exe)
    t0 = time.perf_counter()
    ok, diag = backend_probe.backend_answers(timeout_s=30.0, retries=2, backoff_s=0.1)
    assert not ok and "cuda init exploded" in diag
    assert marks.read_text() == "xxx"  # the first attempt + 2 retries
    assert time.perf_counter() - t0 < 25.0  # the child's verdict, not timeouts


def test_hung_child_hits_the_timeout_with_a_diagnostic(tmp_path, monkeypatch):
    exe = _stub(tmp_path, "import time\ntime.sleep(3600)")
    monkeypatch.setattr(backend_probe.sys, "executable", exe)
    t0 = time.perf_counter()
    ok, diag = backend_probe.backend_answers(timeout_s=1.5, retries=1, backoff_s=0.1)
    dt = time.perf_counter() - t0
    assert not ok and "did not answer within" in diag
    assert 2.5 < dt < 30.0  # two bounded attempts


def test_the_cached_probe_memoizes_the_first_verdict(tmp_path, monkeypatch):
    monkeypatch.setattr(backend_probe, "_memo", None)
    monkeypatch.setattr(backend_probe.sys, "executable",
                        _stub(tmp_path, "print('ok gpu 1 card')"))
    first = backend_probe.cached_backend_answers(timeout_s=30.0)
    assert first == (True, "ok gpu 1 card")
    marks = tmp_path / "attempts"
    monkeypatch.setattr(backend_probe.sys, "executable",
                        _stub(tmp_path, "open(r'%s', 'a').write('x')\nsys.exit(1)" % marks))
    assert backend_probe.cached_backend_answers(timeout_s=30.0) == first
    assert not marks.exists()  # no second child


def test_the_real_child_answers_as_torch_does_here():
    """Without a card the probe fails and names what it lacked; it never
    answers ok for the CPU. With one it names the card."""
    ok, diag = backend_probe.backend_answers(timeout_s=120.0, retries=0)
    if torch.cuda.is_available():
        assert ok and diag.startswith("ok gpu ")
    else:
        assert not ok and "torch.cuda.is_available() is False" in diag
