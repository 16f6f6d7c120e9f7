"""chip_smoke.py must fail, and print no result, without a GPU, outside
a checkout, and when the native host library does not load."""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    r = subprocess.run([sys.executable, script], cwd=cwd,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_requires_native_lib(monkeypatch):
    import jax

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from openvvc_tpu import native

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda: [SimpleNamespace(
        platform="gpu", device_kind="fake")])
    monkeypatch.setattr(native, "load_cabac_lib", lambda: None)
    with pytest.raises(chip_smoke.SmokeError, match="native"):
        chip_smoke.check_device()
