"""GUI front-end wrapper layer (tcforge_tpu/interface.py), mirroring
the reference's testsuite/test_tcinterface.py:29-85 plus coverage for
the cmdline builder and execution manager the reference left stubbed."""

import os
import subprocess
import sys

import numpy as np
import pytest

import tcforge_tpu.interface as tci

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(env):
    env = dict(env)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return env


@pytest.fixture(autouse=True)
def _cpu_children(monkeypatch):
    """Force spawned tools onto the CPU jax backend."""
    orig = tci.TCBinaries.subprocess_env
    monkeypatch.setattr(tci.TCBinaries, "subprocess_env",
                        lambda self: _cpu_env(orig(self)))


class TestConfigManagerProfiles:
    """ConfigManagerProfilesTest (test_tcinterface.py:44-58)."""

    def setup_method(self):
        bins = tci.TCBinaries()
        self.cfg = tci.TCConfigManager(bins)

    def test_creation(self):
        assert self.cfg

    def test_have_profile_path(self):
        assert os.path.exists(self.cfg._profile_path)

    def test_have_profiles(self):
        assert len(self.cfg.profiles) > 1

    def test_exists_profiles(self):
        path = self.cfg._profile_path
        for n in self.cfg.profiles:
            assert os.path.exists(os.path.join(path, f"{n}.cfg"))


class TestSourceFakeProbe:
    """TCSourceFakeProbeTest (test_tcinterface.py:61-81)."""

    def setup_method(self):
        self.src = tci.TCSourceFakeProbe()

    def test_creation(self):
        assert self.src

    def test_path(self):
        assert self.src.path == "N/A"

    def test_named_path(self):
        assert tci.TCSourceFakeProbe("test").path == "test"

    def test_attribute_number(self):
        assert len(self.src.info) == len(tci.TCSourceFakeProbe._remap)

    def test_attribute_value_empty(self):
        for k, v in self.src.info.items():
            assert k
            assert v == ""


class TestSourceProbe:
    """Real probe through tcprobe -R on a generated Y4M."""

    def test_probe_y4m(self, tmp_path):
        from tcforge_tpu.io.y4m import Y4MHeader, Y4MWriter
        p = tmp_path / "probe.y4m"
        hdr = Y4MHeader(width=32, height=16, fps_num=25, fps_den=1)
        rng = np.random.default_rng(0)
        with Y4MWriter(str(p), hdr) as wr:
            for _ in range(3):
                wr.write_frame(
                    rng.integers(0, 255, (16, 32), dtype=np.uint8),
                    rng.integers(0, 255, (8, 16), dtype=np.uint8),
                    rng.integers(0, 255, (8, 16), dtype=np.uint8))
        src = tci.TCSourceProbe(str(p))
        assert src.info["stream path"] == str(p)
        assert src.info["video width"] == "32"
        assert src.info["video height"] == "16"
        assert src.info["video fps"] == "25.000"
        assert src.info["stream media"] == "yuv4mpeg"

    def test_probe_missing_raises(self, tmp_path):
        with pytest.raises(tci.ProbeError):
            tci.TCSourceProbe(str(tmp_path / "nope.avi"))


class TestCmdlineBuilder:
    def test_builder_merges_providers(self):
        bins = tci.TCBinaries()
        bld = tci.TCCmdlineBuilder(bins)

        class P1(tci.TCCmdlineProvider):
            def cmd_options(self):
                return {"-i": "in.y4m", "-o": "out.y4m"}

        class P2(tci.TCCmdlineProvider):
            def cmd_options(self):
                return {"-o": "other.y4m", "--progress_off": ""}

        bld.add_provider(P1())
        bld.add_provider(P2())
        opts = bld.options()
        assert opts.count("-o") == 1          # later provider wins
        assert "other.y4m" in opts
        assert "--progress_off" in opts       # flag without value
        assert opts[opts.index("--progress_off") + 1:] == [] or \
            opts[opts.index("--progress_off") + 1].startswith("-")
        assert bld.command() == bins.transcode
        assert bld.cmdline().startswith(sys.executable)

    def test_provider_abstract(self):
        with pytest.raises(NotImplementedError):
            tci.TCCmdlineProvider().cmd_options()


class TestExecutionManager:
    def test_run_session(self, tmp_path):
        bins = tci.TCBinaries()
        mgr = tci.TCExecutionManager(bins)
        out = tmp_path / "out.y4m"
        assert mgr.status() == "idle"
        mgr.start(["-i", "test://", "-g", "32x16", "--max_frames", "4",
                   "-o", str(out), "--progress_off"])
        assert mgr.status() == "running"
        rc = mgr.stop(timeout=120)
        assert mgr.status() == f"finished({rc})"

    def test_find_exe(self):
        assert os.access(tci.find_exe("sh"), os.X_OK)
        with pytest.raises(tci.MissingExecutableError):
            tci.find_exe("definitely-not-a-real-binary-xyz")
