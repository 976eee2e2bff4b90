"""mplayer pipe importer (import_mplayer.c analogue) — driven by the
in-tree fake mplayer binary (tests/fake_mplayer.py) over real fifos."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tcforge_tpu.core.job import Job
from tcforge_tpu.modules.importers.device_import import MplayerImporter

import tests.fake_mplayer as fake

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def mplayer_on_path(tmp_path, monkeypatch):
    """Install a fake `mplayer` executable at the front of PATH.

    The shim execs the python fixture with a scrubbed environment
    (CPU jax) so it starts fast."""
    shim = tmp_path / "bin" / "mplayer"
    shim.parent.mkdir()
    shim.write_text(
        "#!/bin/sh\n"
        "export PYTHONPATH=/root/repo\n"
        "export JAX_PLATFORMS=cpu\n"
        f'exec "{sys.executable}" "{HERE}/fake_mplayer.py" "$@"\n')
    shim.chmod(0o755)
    monkeypatch.setenv("PATH",
                       str(shim.parent) + os.pathsep + os.environ["PATH"])
    return shim


def expected_video():
    i = np.arange(fake.H)[:, None]
    j = np.arange(fake.W)[None, :]
    ic = np.arange(fake.H // 2)[:, None]
    jc = np.arange(fake.W // 2)[None, :]
    ys, us, vs = [], [], []
    for f in range(fake.FRAMES):
        ys.append((7 * f + 3 * i + j) & 0xFF)
        us.append((13 * f + ic + 2 * jc) & 0xFF)
        vs.append((29 * f + 5 * ic + jc) & 0xFF)
    return (np.stack(ys).astype(np.uint8),
            np.stack(us).astype(np.uint8),
            np.stack(vs).astype(np.uint8))


def expected_pcm():
    s = np.arange(fake.SAMPLES)[:, None]
    c = np.arange(fake.CH)[None, :]
    return (((s * 31 + c * 7) % 8192) - 4096).astype(np.int16)


class TestMplayerImporter:
    def test_gate_without_binary(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PATH", str(tmp_path))  # no mplayer
        imp = MplayerImporter(Job())
        with pytest.raises(NotImplementedError, match="not found in PATH"):
            imp.open("whatever.avi")

    def test_video_stream_bit_exact(self, mplayer_on_path, tmp_path):
        imp = MplayerImporter(Job())
        imp.open(str(tmp_path / "input.avi"))
        assert (imp.width, imp.height) == (fake.W, fake.H)
        assert abs(imp.fps - 25.0) < 1e-9
        got_y, got_u, got_v = [], [], []
        while True:
            b = imp.read_video_batch(5)
            if b is None:
                break
            got_y.append(b["y"])
            got_u.append(b["u"])
            got_v.append(b["v"])
        imp.close()
        y = np.concatenate(got_y)
        ey, eu, ev = expected_video()
        assert y.shape == ey.shape
        np.testing.assert_array_equal(y, ey)
        np.testing.assert_array_equal(np.concatenate(got_u), eu)
        np.testing.assert_array_equal(np.concatenate(got_v), ev)

    def test_audio_stream_bit_exact(self, mplayer_on_path, tmp_path):
        job = Job()
        job.a_rate, job.a_chan = fake.RATE, fake.CH
        imp = MplayerImporter(job)
        imp.open(str(tmp_path / "input.avi"))
        chunks = []
        while True:
            a = imp.read_audio_batch(1024)
            if a is None:
                break
            chunks.append(a)
        imp.close()
        assert imp.audio_rate == fake.RATE
        assert imp.audio_channels == fake.CH
        pcm = np.concatenate(chunks)
        np.testing.assert_array_equal(pcm, expected_pcm())

    def test_im_v_string_passthrough(self, mplayer_on_path, tmp_path,
                                     monkeypatch):
        """-x mplayer=... / --im_v_string options ride the command
        line (import_mplayer.c appended vob->im_v_string)."""
        seen = {}
        real_popen = subprocess.Popen

        def spy(cmd, **kw):
            seen["cmd"] = cmd
            return real_popen(cmd, **kw)

        monkeypatch.setattr(subprocess, "Popen", spy)
        job = Job()
        job.im_v_string = "-fps 25 -vf pp=lb"
        imp = MplayerImporter(job)
        imp.open(str(tmp_path / "input.avi"))
        imp.read_video_batch(2)
        imp.close()
        cmd = seen["cmd"]
        assert "-fps" in cmd and "pp=lb" in cmd
        # extras go before the input path, after the fixed options
        assert cmd[-1].endswith("input.avi")

    def test_mplayer_dies_early_raises(self, tmp_path, monkeypatch):
        """A binary that exits without opening the fifo must raise,
        not deadlock."""
        shim = tmp_path / "bin" / "mplayer"
        shim.parent.mkdir()
        shim.write_text("#!/bin/sh\nexit 3\n")
        shim.chmod(0o755)
        monkeypatch.setenv(
            "PATH", str(shim.parent) + os.pathsep + os.environ["PATH"])
        imp = MplayerImporter(Job())
        imp._SPAWN_TIMEOUT = 10.0
        with pytest.raises(IOError, match="rc=3"):
            imp.open(str(tmp_path / "input.avi"))
