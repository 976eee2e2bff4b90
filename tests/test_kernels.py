"""Pallas Triton kernels (ops/kernels.py: the hqdn3d/denoise3d scans)
against plain references, their split over a mesh, unsharp's separable
form, and the backend dispatch table (tcforge_tpu/backend.py).

The kernels run in interpret mode here; ``test_kernels_on_card`` runs
them compiled on a GPU (marker ``gpu``).
"""

from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tcforge_tpu import backend
from tcforge_tpu.core.formats import ImageFormat as F
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core.job import Job
from tcforge_tpu.modules.filters import denoise3d as d3
from tcforge_tpu.modules.filters import hqdn3d as hq
from tcforge_tpu.ops import kernels

RNG = np.random.default_rng(5)
LUTS = {"hq": (hq.precalc_coefs(4.0), hq.precalc_coefs(6.0)),
        "d3": (d3.precalc_coefs(4.0), d3.precalc_coefs(6.0))}


def rand_u8(*shape):
    return RNG.integers(0, 256, size=shape, dtype=np.uint8)


def np_lowpass(prev, curr, lut, mode):
    if mode == "hq":
        d = np.minimum((prev - curr + 0x10007FF) >> 12, 8191)
    else:
        d = prev - curr + 256
    return curr + lut[d]


def np_scan(x, lut, mode, axis):
    """Independent numpy IIR scan along ``axis`` (int64 arithmetic)."""
    x = np.moveaxis(x.astype(np.int64), axis, 0)
    out = np.empty_like(x)
    out[0] = carry = x[0]
    for s in range(1, x.shape[0]):
        out[s] = carry = np_lowpass(carry, x[s], lut.astype(np.int64),
                                    mode)
    return np.moveaxis(out, 0, axis)


def np_frames(x, carry, lut, mode):
    carry = carry.astype(np.int64)
    lut = lut.astype(np.int64)
    out = np.empty(x.shape, np.int64)
    for s in range(x.shape[0]):
        if mode == "hq":
            dst = np_lowpass(carry << 8, x[s].astype(np.int64), lut, mode)
            out[s] = ((dst + 0x10007FFF) >> 16) & 0xFF
            carry = ((dst + 0x1000007F) >> 8) & 0xFFFF
        else:
            out[s] = carry = np_lowpass(carry, x[s].astype(np.int64),
                                        lut, mode)
    return out.astype(np.uint8), carry


class TestScans:
    @pytest.mark.parametrize("mode", ["hq", "d3"])
    @pytest.mark.parametrize("shape", [(1, 1), (5, 7), (130, 9), (257, 3)])
    def test_row_scan(self, mode, shape):
        """Row counts that are not a multiple of the block are masked."""
        x = rand_u8(*shape)
        got = np.asarray(kernels.row_scan(jnp.asarray(x),
                                          jnp.asarray(LUTS[mode][0]),
                                          mode=mode, interpret=True))
        xin = x.astype(np.int64) << (16 if mode == "hq" else 0)
        np.testing.assert_array_equal(got, np_scan(xin, LUTS[mode][0],
                                                   mode, 1))

    @pytest.mark.parametrize("mode", ["hq", "d3"])
    @pytest.mark.parametrize("shape", [(1, 4, 3), (2, 9, 130),
                                       (3, 5, 129)])
    def test_col_scan(self, mode, shape):
        """Widths that are not a power of two, below and above one
        block."""
        x = rand_u8(*shape)
        if mode == "hq":
            x = x.astype(np.int32) << 16
        got = np.asarray(kernels.col_scan(jnp.asarray(x),
                                          jnp.asarray(LUTS[mode][0]),
                                          mode=mode, interpret=True))
        np.testing.assert_array_equal(got, np_scan(x, LUTS[mode][0],
                                                   mode, 1))

    @pytest.mark.parametrize("mode", ["hq", "d3"])
    @pytest.mark.parametrize("shape", [(1, 5), (4, 130), (7, 257)])
    def test_frame_scan(self, mode, shape):
        n, p = shape
        if mode == "hq":
            x = rand_u8(n, p).astype(np.int32) << 16
            carry = RNG.integers(0, 1 << 16, p).astype(np.int32)
        else:
            x = rand_u8(n, p)
            carry = rand_u8(p).astype(np.int32)
        got, gc = kernels.frame_scan(jnp.asarray(x), jnp.asarray(carry),
                                     jnp.asarray(LUTS[mode][1]),
                                     mode=mode, interpret=True)
        want, wc = np_frames(x, carry, LUTS[mode][1], mode)
        np.testing.assert_array_equal(np.asarray(got), want)
        np.testing.assert_array_equal(np.asarray(gc), wc)


def _ref_plane(mode, frames, carry):
    s, t = (jnp.asarray(a) for a in LUTS[mode])
    if mode == "hq":
        return hq.denoise_plane(frames, carry, s, t)
    return d3.denoise_plane(frames, carry, s, s, t)


def _kernel_plane(mode, frames, carry, **kw):
    s, t = (jnp.asarray(a) for a in LUTS[mode])
    fn = kernels.hqdn3d_plane if mode == "hq" else kernels.denoise3d_plane
    return fn(frames, carry, s, t, interpret=True, **kw)


def _carry0(mode, frames):
    if mode == "hq":
        return jnp.asarray(frames[0].astype(np.int32) << 8)
    return jnp.asarray(rand_u8(*frames.shape[1:]).astype(np.int32))


class TestPlanes:
    @pytest.mark.parametrize("mode", ["hq", "d3"])
    @pytest.mark.parametrize("shape", [(3, 5, 7), (2, 9, 130)])
    def test_plane_matches_lax_scan(self, mode, shape):
        f = rand_u8(*shape)
        c = _carry0(mode, f)
        want, wc = _ref_plane(mode, jnp.asarray(f), c)
        got, gc = _kernel_plane(mode, jnp.asarray(f), c)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))

    @pytest.mark.parametrize("mode", ["hq", "d3"])
    def test_batch_size_invariance(self, mode):
        """Six frames as one batch or as 2 + 4 with the carry threaded
        between them give the same output."""
        f = rand_u8(6, 8, 12)
        c = _carry0(mode, f)
        whole, wc = _kernel_plane(mode, jnp.asarray(f), c)
        a, ca = _kernel_plane(mode, jnp.asarray(f[:2]), c)
        b, cb = _kernel_plane(mode, jnp.asarray(f[2:]), ca)
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(a), np.asarray(b)]),
            np.asarray(whole))
        np.testing.assert_array_equal(np.asarray(cb), np.asarray(wc))

    @pytest.mark.parametrize("mode", ["hq", "d3"])
    def test_under_mesh_matches_single_device(self, mode):
        """Under a (data 2, spatial 2) mesh the cascade runs per device
        through shard_map and must not change a bit."""
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        f = rand_u8(4, 8, 16)
        c = _carry0(mode, f)
        want, wc = _kernel_plane(mode, jnp.asarray(f), c)
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("data", "spatial"))
        fs = jax.device_put(f, NamedSharding(mesh, P("data", None,
                                                     "spatial")))
        with jax.set_mesh(mesh):
            got, gc = jax.jit(lambda a, b: _kernel_plane(mode, a, b))(fs, c)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))


class TestTemporalClamp:
    """FrameAnt at 0xFFFF over a black pixel indexes the hqdn3d LUT at
    8192; every implementation clamps it to 8191 (coefficient 0)."""

    def _case(self):
        f = np.zeros((2, 4, 8), np.uint8)
        ant = np.full((4, 8), 0xFFFF, np.int32)
        return f, ant

    def test_scan_and_kernel_agree(self):
        f, ant = self._case()
        want, wc = _ref_plane("hq", jnp.asarray(f), jnp.asarray(ant))
        got, gc = _kernel_plane("hq", jnp.asarray(f), jnp.asarray(ant))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))
        # coefficient 0: the first output is the (black) input itself
        assert (np.asarray(want)[0] == 0).all()

    def test_native_agrees(self):
        from tcforge_tpu import native
        if not native.hqdn3d_available():
            pytest.skip("native host lib not built")
        f, ant = self._case()
        want, wc = _ref_plane("hq", jnp.asarray(f), jnp.asarray(ant))
        s, t = LUTS["hq"]
        got, gc = native.hqdn3d_plane(f, ant.copy(), s, t)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(gc, np.asarray(wc))

    def test_numpy_golden_agrees(self):
        f, ant = self._case()
        want, wc = _ref_plane("hq", jnp.asarray(f), jnp.asarray(ant))
        x = np_scan(np_scan(f.astype(np.int64) << 16, LUTS["hq"][0], "hq",
                            2), LUTS["hq"][0], "hq", 1)
        got, gc = np_frames(x, ant, LUTS["hq"][1], "hq")
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(gc.reshape(ant.shape),
                                      np.asarray(wc))


def np_cascade(img, steps_x, steps_y):
    """The FSM's 2*steps cascaded [1,1] stages per axis with edge
    replication, in numpy uint32 (wrapping like the C accumulators)."""
    a = img.astype(np.uint32)
    a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(steps_x, steps_x)],
               mode="edge")
    for _ in range(2 * steps_x):
        a = a[..., 1:] + a[..., :-1]
    a = np.pad(a, [(0, 0)] * (a.ndim - 2) + [(steps_y, steps_y), (0, 0)],
               mode="edge")
    for _ in range(2 * steps_y):
        a = a[..., 1:, :] + a[..., :-1, :]
    return a


class TestUnsharp:
    """unsharp's separable binomial taps (the one path on every
    backend) against the shift-add cascade they replace."""

    @pytest.mark.parametrize("shape,mx,my,amount", [
        ((2, 9, 70), 7, 5, 0.8),
        ((3, 20, 17), 3, 3, -0.5),      # blur
        ((1, 5, 130), 9, 3, 1.7),
        # 32 scale bits, the most the reference's halfscale allows:
        # the uint32 accumulator wraps
        ((1, 6, 40), 31, 3, 2.0),
        ((2, 40, 5), 3, 31, -2.0),
    ])
    def test_matches_cascade(self, shape, mx, my, amount):
        from tcforge_tpu.modules.filters.unsharp import (_binomial_blur_acc,
                                                         unsharp_plane)
        img = rand_u8(*shape)
        sx, sy = mx // 2, my // 2
        acc = np_cascade(img, sx, sy)
        np.testing.assert_array_equal(
            np.asarray(_binomial_blur_acc(jnp.asarray(img), sx, sy)), acc)
        scalebits = (sx + sy) * 2
        blur = ((acc + np.uint32(1 << (scalebits - 1))) >> scalebits) \
            .astype(np.int64)
        src = img.astype(np.int64)
        want = np.clip(src + (((src - blur) * int(amount * 65536.0)) >> 16),
                       0, 255).astype(np.uint8)
        np.testing.assert_array_equal(
            np.asarray(unsharp_plane(jnp.asarray(img), mx, my, amount)),
            want)

    def test_under_mesh_matches_single_device(self):
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from tcforge_tpu.modules.filters.unsharp import unsharp_plane
        img = rand_u8(4, 8, 16)
        want = unsharp_plane(jnp.asarray(img), 3, 5, 0.8)
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("data", "spatial"))
        xs = jax.device_put(img, NamedSharding(mesh, P("data", None,
                                                       "spatial")))
        with jax.set_mesh(mesh):
            got = jax.jit(lambda a: unsharp_plane(a, 3, 5, 0.8))(xs)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


class TestSplit:
    """Under a mesh each pass runs once per device on its share of the
    lanes (``kernels._split``), padded to a multiple of the device
    count."""

    def _mesh(self, n):
        from jax.sharding import Mesh
        return Mesh(np.asarray(jax.devices()[:n]).reshape(-1, 2),
                    ("data", "spatial"))

    @pytest.mark.parametrize("rows", [8, 9, 3])
    def test_row_scan_split(self, rows):
        """Row counts divisible by four, and not (padded lanes)."""
        x = jnp.asarray(rand_u8(rows, 11))
        lut = jnp.asarray(LUTS["hq"][0])
        want = kernels.row_scan(x, lut, mode="hq", interpret=True)
        seen = []

        def fn(a, b):
            seen.append(a.shape)
            return (kernels.row_scan(a, b, mode="hq", interpret=True),)
        with jax.set_mesh(self._mesh(4)):
            (got,) = jax.jit(lambda a, b: kernels._split(
                fn, (a, b), ((kernels.LANES, None), ()),
                ((kernels.LANES, None),)))(x, lut)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert seen == [(-(-rows // 4), 11)]

    @pytest.mark.parametrize("mode", ["hq", "d3"])
    def test_frame_scan_split_keeps_carry(self, mode):
        """The temporal pass splits pixels and its carry alike."""
        x = rand_u8(3, 10)
        carry = rand_u8(10).astype(np.int32)
        lut = jnp.asarray(LUTS[mode][1])
        want, wc = np_frames(x, carry, LUTS[mode][1], mode)
        fn = partial(kernels.frame_scan, mode=mode, interpret=True)
        with jax.set_mesh(self._mesh(8)):
            got, gc = jax.jit(lambda a, c, t: kernels._split(
                fn, (a, c, t),
                ((None, kernels.LANES), (kernels.LANES,), ()),
                ((None, kernels.LANES), (kernels.LANES,))))(
                jnp.asarray(x), jnp.asarray(carry), lut)
        np.testing.assert_array_equal(np.asarray(got), want)
        np.testing.assert_array_equal(np.asarray(gc), wc)

    def test_no_mesh_calls_through(self):
        x = jnp.arange(6)
        assert kernels._split(lambda a: (a + 1,), (x,), ((kernels.LANES,),),
                              ((kernels.LANES,),))[0].shape == (6,)

    @pytest.mark.parametrize("mode", ["hq", "d3"])
    @pytest.mark.parametrize("shape", [(2, 6, 10), (3, 5, 7)])
    def test_plane_under_mesh_odd_batches(self, mode, shape):
        """Batches and planes the mesh does not divide."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        f = rand_u8(*shape)
        c = _carry0(mode, f)
        want, wc = _ref_plane(mode, jnp.asarray(f), c)
        mesh = self._mesh(4)
        with jax.set_mesh(mesh):
            got, gc = jax.jit(lambda a, b: _kernel_plane(mode, a, b))(
                jax.device_put(f, NamedSharding(mesh, P())), c)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))


@pytest.mark.gpu
def test_kernels_on_card(gpu_device):
    """The compiled Triton kernels against lax.scan on the card."""
    import chip_smoke
    chip_smoke.phase_kernels(width=640, height=360, batch=4)


class TestBackendTable:
    @pytest.mark.parametrize("op", sorted(backend.PATHS))
    def test_every_op_has_cpu_and_gpu(self, op):
        assert set(backend.PATHS[op]) == {"cpu", "gpu"}
        assert backend.path(op) == backend.PATHS[op]["cpu"]

    def test_unknown_backend_is_an_error(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(RuntimeError):
            backend.path("zoom")

    def test_hqdn3d_host_stage_on_cpu(self):
        from tcforge_tpu import native
        filt = hq.Hqdn3dFilter(Job(), "luma=4.0")
        assert filt.host_stage() == native.hqdn3d_available()
        assert not hq.Hqdn3dFilter(Job(), "nonative=1").host_stage()

    @pytest.mark.parametrize("name", ["hqdn3d", "denoise3d"])
    def test_filter_takes_kernel_where_table_says(self, name,
                                                  monkeypatch):
        """With the table set to the Triton path, apply() calls the
        kernel cascade (here interpreted) and matches the scan path."""
        cls = hq.Hqdn3dFilter if name == "hqdn3d" else d3.Denoise3dFilter
        y, u, v = rand_u8(3, 8, 16), rand_u8(3, 4, 8), rand_u8(3, 4, 8)
        fb = FrameBatch(format=F.YUV420P, y=jnp.asarray(y),
                        u=jnp.asarray(u), v=jnp.asarray(v), fps=25.0)
        filt = cls(Job(), "")
        st = filt.init_state(16, 8, F.YUV420P)
        want, _ = filt.apply(fb, st)
        calls = []
        fn_name = "hqdn3d_plane" if name == "hqdn3d" else "denoise3d_plane"
        real = getattr(kernels, fn_name)

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, interpret=True)
        monkeypatch.setattr(kernels, fn_name, spy)
        monkeypatch.setitem(backend.PATHS["denoise_scan"], "cpu",
                            "triton")
        assert not cls(Job(), "").host_stage()
        got, _ = cls(Job(), "").apply(fb, st)
        assert len(calls) == 3
        for a, b in ((got.y, want.y), (got.u, want.u), (got.v, want.v)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.parametrize("form", ["f32", "s8"])
    def test_zoom_form_from_table_is_exact(self, form, monkeypatch):
        from tcforge_tpu.ops import zoom
        monkeypatch.setitem(backend.PATHS["zoom"], "cpu", form)
        img = jnp.asarray(rand_u8(2, 30, 44))
        for w_fix, axis in ((zoom.contrib_matrix(44, 29, "lanczos3"), -1),
                            (zoom.contrib_matrix(30, 17, "mitchell"), -2)):
            np.testing.assert_array_equal(
                np.asarray(zoom._apply_pass_matmul(img, w_fix, axis)),
                np.asarray(zoom._apply_pass_exact(img, w_fix, axis)))

    def test_mc_form_follows_table(self, monkeypatch):
        from tcforge_tpu.io import mpeg2enc
        assert not mpeg2enc._use_shift_mc()
        monkeypatch.setitem(backend.PATHS["mpeg2_mc"], "cpu", "shift")
        assert mpeg2enc._use_shift_mc()


class TestCompileCache:
    def test_env_is_left_to_jax(self, monkeypatch, tmp_path):
        seen = []
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: seen.append(a))
        assert backend.init_compile_cache() == str(tmp_path)
        assert seen == []

    def test_fallback_is_fixed_in_checkout(self, monkeypatch):
        import os
        seen = []
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: seen.append(a))
        d = backend.init_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            backend.__file__)))
        assert d == os.path.join(root, ".jax_cache")
        assert seen == [("jax_compilation_cache_dir", d)]
        assert backend.init_compile_cache() == d      # stable across calls
