"""PCM audio ops: the libtcaudio layer.

JAX-native rebuild of ``libtcaudio/tcaudio.c`` (tca_convert_from/to,
tca_amplify, tca_mono_to_stereo, tca_stereo_to_mono) as batched jnp
functions over (..., S, C) sample tensors.  Internal canonical sample
format is int16 (TCA_S16LE analogue); u8/big-endian byte orders are
handled at the container boundary in :mod:`tcforge_tpu.io`.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

Array = jnp.ndarray


def u8_to_s16(pcm: Array) -> Array:
    """TCA_U8 -> S16: center at 0 and scale by 256 (tca_convert
    semantics: 8-bit unsigned samples biased by 0x80)."""
    return ((pcm.astype(jnp.int32) - 0x80) << 8).astype(jnp.int16)


def s16_to_u8(pcm: Array) -> Array:
    """S16 -> TCA_U8: high byte + 0x80 bias."""
    return ((pcm.astype(jnp.int32) >> 8) + 0x80).astype(jnp.uint8)


def amplify(pcm: Array, scale: float) -> Tuple[Array, Array]:
    """Volume scaling with clip counting (tca_amplify,
    libtcaudio/tcaudio.c:154-207): v = floor(sample*scale + 0.5), clamped
    to the int16 range; every clipped sample increments the count.

    Returns (scaled_pcm, nclip) where nclip is a scalar int32 (summed
    over the batch; the engine accumulates it for the session summary).
    """
    v = jnp.floor(pcm.astype(jnp.float32) * jnp.float32(scale) + 0.5)
    v = v.astype(jnp.int32)
    clipped = (v > 0x7FFF) | (v < -0x8000)
    nclip = jnp.sum(clipped.astype(jnp.int32))
    out = jnp.clip(v, -0x8000, 0x7FFF).astype(jnp.int16)
    return out, nclip


def mono_to_stereo(pcm: Array) -> Array:
    """Duplicate mono samples into both channels (tca_mono_to_stereo,
    tcaudio.c:223-258).  (..., S, 1) -> (..., S, 2)."""
    if pcm.shape[-1] != 1:
        raise ValueError("mono_to_stereo expects 1 channel")
    return jnp.concatenate([pcm, pcm], axis=-1)


def stereo_to_mono(pcm: Array) -> Array:
    """Rounded per-sample average (tca_stereo_to_mono, tcaudio.c:267-295):
    (l + r + 1) / 2 in int32, C division truncating toward zero."""
    if pcm.shape[-1] != 2:
        raise ValueError("stereo_to_mono expects 2 channels")
    s = pcm[..., 0].astype(jnp.int32) + pcm[..., 1].astype(jnp.int32) + 1
    # C '/ 2' truncates toward zero; arithmetic >>1 floors, so fix negatives
    mono = jnp.where(s < 0, -((-s) >> 1), s >> 1)
    return mono.astype(jnp.int16)[..., None]


def resample_linear(pcm: Array, src_rate: int, dst_rate: int) -> Array:
    """Linear-interpolation resampler (filter_resample analogue for the
    raw path; the reference delegates to lavc's polyphase resampler —
    a windowed-sinc version lives in modules.filters.resample).

    (..., S, C) -> (..., S', C) with S' = floor(S * dst/src).
    """
    if src_rate == dst_rate:
        return pcm
    s = pcm.shape[-2]
    new_s = int(s * dst_rate // src_rate)
    pos = jnp.arange(new_s, dtype=jnp.float32) * (src_rate / dst_rate)
    idx0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, s - 1)
    idx1 = jnp.clip(idx0 + 1, 0, s - 1)
    frac = (pos - idx0.astype(jnp.float32))[..., None]
    a = pcm[..., idx0, :].astype(jnp.float32)
    b = pcm[..., idx1, :].astype(jnp.float32)
    out = a + (b - a) * frac
    return jnp.round(out).astype(pcm.dtype)


# --------------------------------------------------------------------- #
# Polyphase windowed-sinc resampler (the quality path the reference got
# from lavc's polyphase resampler, filter/filter_resample.c:272) —
# expressed as a dense contributor-matrix GEMM like libtcvideo's zoom
# resampler (libtcvideo/zoom.c contributor lists), which is the shape
# matrix units want.

_RESAMPLE_CACHE = {}


def _kaiser(n, beta: float):
    import numpy as np
    return np.i0(beta * np.sqrt(np.clip(
        1.0 - (2.0 * n / (len(n) - 1) - 1.0) ** 2, 0.0, 1.0))) \
        / np.i0(beta)


def resample_coeffs(s_in: int, src_rate: int, dst_rate: int,
                    taps: int = 32, beta: float = 9.0):
    """Contributor lists for windowed-sinc resampling: per output
    sample a (taps,) index row into the input and a (taps,) coefficient
    row.  Windowed-sinc interpolation at output times n*src/dst,
    cutoff min(1, dst/src) for anti-aliasing, Kaiser window,
    edge-replicated boundaries, rows normalized to unit DC gain —
    libtcvideo/zoom.c's contributor design applied to audio, kept as
    gather+reduce instead of a dense (s_out, s_in) matrix so memory
    stays O(s_out * taps)."""
    import numpy as np
    key = (s_in, src_rate, dst_rate, taps, beta)
    hit = _RESAMPLE_CACHE.get(key)
    if hit is not None:
        return hit
    s_out = int(s_in * dst_rate // src_rate)
    ratio = src_rate / dst_rate
    fc = min(1.0, 1.0 / ratio)
    t = np.arange(s_out, dtype=np.float64) * ratio       # (s_out,)
    base = np.floor(t).astype(np.int64)
    half = taps // 2
    k = np.arange(-half + 1, half + 1)                   # (taps,)
    j = base[:, None] + k[None, :]                       # sample indices
    x = j - t[:, None]                                   # distance
    h = fc * np.sinc(fc * x)
    win = _kaiser(np.arange(taps), beta)
    # window positioned on the tap grid (phase-invariant Kaiser)
    h = h * win[None, :]
    h /= h.sum(axis=1, keepdims=True)
    jc = np.clip(j, 0, s_in - 1)                         # edge replicate
    out = (jc.astype(np.int32), h.astype(np.float32))
    _RESAMPLE_CACHE[key] = out
    return out


def resample_poly(pcm: Array, src_rate: int, dst_rate: int,
                  taps: int = 32, beta: float = 9.0) -> Array:
    """Polyphase windowed-sinc resampling of (..., S, C) PCM: gather
    the (s_out, taps) contributor windows, one fused multiply-reduce."""
    if src_rate == dst_rate:
        return pcm
    s = pcm.shape[-2]
    idx, coef = resample_coeffs(s, src_rate, dst_rate, taps, beta)
    idxj = jnp.asarray(idx)
    coefj = jnp.asarray(coef)[..., None]                 # (s_out, taps, 1)
    gathered = pcm.astype(jnp.float32)[..., idxj, :]     # (..., s_out, taps, C)
    out = (gathered * coefj).sum(axis=-2)
    if pcm.dtype == jnp.int16:
        out = jnp.clip(jnp.round(out), -32768, 32767)
    return out.astype(pcm.dtype)


class StreamingResampler:
    """Exact streaming polyphase windowed-sinc resampler (host/numpy).

    Same contributor math as :func:`resample_poly`, but the output
    time grid is GLOBAL (t_m = m * src / dst from stream start) and
    the filter history carries across calls, so the output is
    batch-size-invariant: feeding the same stream in chunks of 4 or
    4096 samples yields identical bytes.  Outputs whose sinc window
    extends past the received input are held back until more input
    (or :meth:`flush`, which edge-replicates the final samples like
    the block resampler's right boundary).
    """

    def __init__(self, src_rate: int, dst_rate: int, channels: int,
                 taps: int = 32, beta: float = 9.0):
        import math

        import numpy as np
        g = math.gcd(int(src_rate), int(dst_rate))
        self.src = int(src_rate) // g
        self.dst = int(dst_rate) // g
        self.channels = channels
        self.taps = taps
        self.half = taps // 2
        self.fc = min(1.0, self.dst / self.src)
        self._win = _kaiser(np.arange(taps), beta)
        self._k = np.arange(-self.half + 1, self.half + 1)
        self._buf = np.zeros((0, channels), np.float32)
        self._start = 0          # global input index of _buf[0]
        self._m = 0              # next global output index
        self._total = 0          # input samples received
        self._dtype = None
        # the coefficient row depends only on frac(m*src/dst), which
        # cycles with period dst: precompute all phases once (the
        # per-batch sinc() evaluation dominated profile otherwise)
        self._phases = None
        if self.dst <= 8192:
            fracs = np.arange(self.dst) / self.dst
            x = self._k[None, :] - fracs[:, None]
            h = self.fc * np.sinc(self.fc * x) * self._win[None, :]
            h /= h.sum(axis=1, keepdims=True)
            self._phases = h.astype(np.float32)

    def _emit(self, m_hi: int, np, pad_tail: int = 0):
        if m_hi <= self._m:
            return np.zeros((0, self.channels),
                            self._dtype or np.int16)
        ms = np.arange(self._m, m_hi, dtype=np.int64)
        base = (ms * self.src) // self.dst
        j = base[:, None] + self._k[None, :]
        if self._phases is not None:
            h = self._phases[(ms * self.src) % self.dst]
        else:
            t = ms * (self.src / self.dst)
            x = j - t[:, None]
            h = (self.fc * np.sinc(self.fc * x)
                 * self._win[None, :])
            h /= h.sum(axis=1, keepdims=True)
            h = h.astype(np.float32)
        buf = self._buf
        if pad_tail:
            buf = np.concatenate([buf, np.repeat(buf[-1:], pad_tail,
                                                 axis=0)])
        # contributor windows are CONSECUTIVE taps: use a strided
        # window view + einsum for the body (the (s_out, taps, C)
        # fancy gather dominated the profile); rows whose window
        # would start before the buffer (stream head) take the
        # clipped-gather path
        idx0 = (base - self._start - self.half + 1)
        nb = len(buf)
        ok = (idx0 >= 0) & (idx0 + self.taps <= nb)
        if ok.all():
            win = np.lib.stride_tricks.sliding_window_view(
                buf, self.taps, axis=0)          # (nb-taps+1, C, taps)
            out = np.einsum("sct,st->sc", win[idx0], h,
                            optimize=True)
        else:
            out = np.empty((len(ms), self.channels), np.float32)
            sel = np.nonzero(ok)[0]
            if len(sel):
                win = np.lib.stride_tricks.sliding_window_view(
                    buf, self.taps, axis=0)
                out[sel] = np.einsum("sct,st->sc", win[idx0[sel]],
                                     h[sel], optimize=True)
            rest = np.nonzero(~ok)[0]
            j_r = j[rest] - self._start
            jc = np.clip(j_r, 0, nb - 1)
            out[rest] = (buf[jc] * h[rest][:, :, None]).sum(axis=1)
        if self._dtype == np.int16:
            out = np.clip(np.rint(out), -32768, 32767)
        self._m = int(m_hi)
        return out.astype(self._dtype or np.float32)

    def process(self, pcm):
        """Feed (S, C) samples; return every output sample whose
        window is fully covered by the input so far."""
        import numpy as np
        if self._dtype is None:
            self._dtype = pcm.dtype.type if hasattr(pcm, "dtype") \
                else np.int16
        pcm = np.asarray(pcm, np.float32).reshape(-1, self.channels)
        self._buf = np.concatenate([self._buf, pcm])
        self._total += len(pcm)
        t_last = self._total - 1 - self.half
        if t_last < 0:
            return np.zeros((0, self.channels), self._dtype)
        m_hi = ((t_last + 1) * self.dst - 1) // self.src + 1
        out = self._emit(m_hi, np)
        # drop the consumed head (keep what future windows reach)
        keep_from = max(self._start,
                        (self._m * self.src) // self.dst
                        - self.half + 1)
        self._buf = self._buf[keep_from - self._start:]
        self._start = keep_from
        return out

    def flush(self):
        """Emit the held-back tail (right-edge replication); total
        output count is floor(total_in * dst / src) like the block
        resampler."""
        import numpy as np
        if self._dtype is None or self._total == 0:
            return np.zeros((0, self.channels), np.int16)
        m_hi = (self._total * self.dst) // self.src
        return self._emit(m_hi, np, pad_tail=self.taps)
