"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal of a
non-GPU device, and the cluster driver's one-process-per-card rule."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from tcforge_tpu.tools import cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


class TestMain:
    def test_exits_nonzero_on_cpu(self):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                           env=_cpu_env(), capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    def test_fails_without_the_repo(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("PYTHONPATH", None)
        r = subprocess.run([sys.executable, "chip_smoke.py"],
                           cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    def test_no_subset_of_phases(self):
        """The ok line always means every phase ran: there is no
        option that runs only some of them."""
        with pytest.raises(SystemExit):
            chip_smoke.main(["--only", "kernels"])

    def test_device_phase_refuses_cpu(self):
        with pytest.raises(SystemExit):
            chip_smoke.phase_device("gpu")
        assert chip_smoke.phase_device("cpu")["platform"] == "cpu"

    def test_same_bytes_reports_difference(self, tmp_path):
        a, b = tmp_path / "a", tmp_path / "b"
        a.write_bytes(b"\x00\x01\x02")
        b.write_bytes(b"\x00\x07\x02")
        with pytest.raises(AssertionError, match="1 bytes differ"):
            chip_smoke._same_bytes(str(a), str(b), "t")
        chip_smoke._same_bytes(str(a), str(a), "t")


class TestPhasesTiny:
    def test_kernels(self):
        chip_smoke.phase_kernels(width=70, height=34, batch=3,
                                 interpret=True)

    def test_chain_north_star(self, tmp_path):
        chip_smoke.phase_chain(str(tmp_path), chip_smoke.north_star(96, 64),
                               "chain", 96, 64, 7)

    def test_chain2(self, tmp_path):
        chip_smoke.phase_chain(str(tmp_path), chip_smoke.CHAIN2, "chain2",
                               96, 64, 7)

    def test_mpeg2(self, tmp_path):
        chip_smoke.phase_mpeg2(str(tmp_path), 96, 64, 7)

    def test_four_on_virtual_devices(self, tmp_path):
        chip_smoke.phase_four(str(tmp_path), 96, 64, 7)

    def test_ab(self, tmp_path, capsys):
        chip_smoke.run_ab(str(tmp_path), "cpu", 48, 32, 2,
                          sd=(48, 32, 4), interpret=True)
        out = capsys.readouterr().out
        assert "hqdn3d luma 2x32x48 triton" in out
        assert "zoom s8" in out and "DIFFERS" not in out


_BLOCKED = """
import sys
class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cv2", "PIL", "scipy"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Blocked())
from tcforge_tpu import cli
for args in sys.argv[1:]:
    rc = cli.main(args.split())
    if rc:
        sys.exit(rc)
"""


def test_main_path_needs_only_numpy_and_jax(tmp_path):
    """The chip_smoke commands run with cv2, PIL and scipy unimportable."""
    src = " ".join(chip_smoke._source(96, 64, 7))
    m2v = tmp_path / "a.m2v"
    cmds = [f"{src} {' '.join(chip_smoke.north_star(96, 64))} "
            f"-o {tmp_path / 'a.y4m'}",
            f"{src} {' '.join(chip_smoke.CHAIN2)} -o {tmp_path / 'b.y4m'}",
            f"{src} -y mpeg2,null -F gop_n=12:gop_m=3 -w 5000 -o {m2v}",
            f"-i {m2v} -q --progress_off -o {tmp_path / 'c.y4m'}"]
    r = subprocess.run([sys.executable, "-c", _BLOCKED] + cmds, cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "c.y4m").stat().st_size > 0


class _FakeProc:
    live = []
    peak = 0
    shared = 0

    def __init__(self, cmd, env):
        self.args, self.env, self.polls = cmd, env, 0
        card = env.get("CUDA_VISIBLE_DEVICES")
        if card is not None and any(
                q.env.get("CUDA_VISIBLE_DEVICES") == card
                for q in _FakeProc.live):
            _FakeProc.shared += 1
        _FakeProc.live.append(self)
        _FakeProc.peak = max(_FakeProc.peak, len(_FakeProc.live))
        self.returncode = None

    def poll(self):
        self.polls += 1
        if self.polls >= 2 and self.returncode is None:
            self.returncode = int(self.args[-1])
            _FakeProc.live.remove(self)
        return self.returncode


class TestCluster:
    @pytest.fixture
    def fake(self, monkeypatch):
        _FakeProc.live, _FakeProc.peak, _FakeProc.shared = [], 0, 0
        started = []

        def popen(cmd, env):
            p = _FakeProc(cmd, env)
            started.append(p)
            return p
        monkeypatch.setattr(cluster.subprocess, "Popen", popen)
        monkeypatch.setattr(cluster.time, "sleep", lambda s: None)
        return started

    def test_visible_gpus_from_env(self, monkeypatch):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 5")
        assert cluster.visible_gpus() == ["2", "5"]
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        assert cluster.visible_gpus() == []

    def test_one_process_per_card(self, fake):
        cmds = [["x", "0"]] * 5
        rcs = cluster.run_chunks(cmds, 4, ["0", "1"])
        assert rcs == [0] * 5
        assert _FakeProc.peak == 2
        for p in fake:
            assert p.env["CUDA_VISIBLE_DEVICES"] in ("0", "1")

    def test_no_cards_keeps_job_cap_and_env(self, fake, monkeypatch):
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        rcs = cluster.run_chunks([["x", "0"], ["x", "3"], ["x", "0"]], 2,
                                 [])
        assert rcs == [0, 3, 0]
        assert _FakeProc.peak == 2
        assert all("CUDA_VISIBLE_DEVICES" not in p.env for p in fake)

    def test_cards_in_use_are_never_shared(self, fake):
        cluster.run_chunks([["x", "0"]] * 6, 3, ["0", "1", "2"])
        assert _FakeProc.shared == 0
        assert np.unique([p.env["CUDA_VISIBLE_DEVICES"]
                          for p in fake]).size == 3
