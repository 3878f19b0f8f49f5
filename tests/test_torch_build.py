"""The kernel build's process hygiene (no compiler is run: ``nvcc`` is a
stand-in that sleeps)."""
import subprocess
import sys

import pytest

from repro_torch.kernels import build


def test_an_interrupted_build_leaves_no_compiler_running(tmp_path,
                                                         monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b", "c"):
        (csrc / f"{name}.cu").write_text("// empty\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: sys.executable)
    started = []
    real_popen = subprocess.Popen

    class Popen(real_popen):
        def __init__(self, cmd, **kw):
            # each "compiler" sleeps far past the test
            super().__init__([sys.executable, "-c",
                              "import time; time.sleep(60)"], **kw)
            started.append(self)

        def communicate(self, *a, **kw):
            raise KeyboardInterrupt

    monkeypatch.setattr(build.subprocess, "Popen", Popen)
    with pytest.raises(KeyboardInterrupt):
        build.build_all(("a", "b", "c"))
    assert len(started) == 3
    assert all(p.poll() is not None for p in started)
    assert not any(build.lib_path(n).exists() for n in ("a", "b", "c"))
