"""Steering geometry and coefficient design (host-side, NumPy).

Re-implements the math of the reference's ``PC/src/directions.pyx`` as
vectorized NumPy, generalized over :class:`~..config.Config` instead of
compile-time ``#define``s:

* mic xy-coordinates            — ``directions.pyx:17-32``  (``calc_r_prime``)
* active-mic selection          — ``directions.pyx:35-87``  (``active_microphones``)
* cartesian-window delay model  — ``directions.pyx:90-124`` (``calculate_delays``)
* angle-grid delay model        — ``directions.pyx:126-157``
* single-direction MISO delays  — ``directions.pyx:159-187``
* 8-tap sinc×Blackman designer  — ``directions.pyx:189-226`` (``get_h``/``get_h2``)
* full FIR bank                 — ``directions.pyx:229-254``
* whole+fractional split        — ``directions.pyx:260-277``
* FFT-domain phase tensor       — ``PC/application/realtime_scripts/calc_phase_shift_cartesian.py:44-50``

All table building happens once per configuration on the host in float64
(matching the reference's NumPy behaviour) and is cast to float32 before it
reaches the device.
"""

from __future__ import annotations

import numpy as np

from ..config import Config


# ---------------------------------------------------------------------------
# Microphone selection & geometry
# ---------------------------------------------------------------------------

def active_microphones(cfg: Config) -> tuple[np.ndarray, int]:
    """Indices of active microphones, ascending.

    Mirrors ``directions.pyx:35-87``: the mic-index plane is the horizontal
    concatenation of per-array ``(rows, columns)`` index blocks; the
    decimation mode ``skip_n_mics`` strides both rows and columns
    (1 = all mics, 2 = every 2nd, ...); mics listed in ``cfg.unused_mics``
    (the ``unused_mics.npy`` deadmap, already absolute indices here) are
    dropped.
    """
    mode = cfg.skip_n_mics
    rows = np.arange(0, cfg.rows, mode)
    columns = np.arange(0, cfg.columns * cfg.array_slots, mode)

    arr_elem = cfg.rows * cfg.columns
    blocks = [
        np.arange(a * arr_elem, (a + 1) * arr_elem).reshape(cfg.rows, cfg.columns)
        for a in range(cfg.array_slots)
    ]
    microphones = np.hstack(blocks)

    unused = set(int(m) for m in cfg.unused_mics)
    active = [
        int(microphones[r, c])
        for r in rows
        for c in columns
        if int(microphones[r, c]) not in unused
    ]
    active = np.sort(np.asarray(active, dtype=np.int64))
    return active, len(active)


def r_prime(cfg: Config) -> np.ndarray:
    """xy positions (2, n_active) of the active microphones [m].

    Mirrors ``directions.pyx:17-32`` including its sign conventions: array
    slot index is negated (boards daisy-chain to the left) and the whole
    plane is recentred by ``columns * array_slots * half``.
    """
    d = cfg.element_distance
    half = d / 2
    n_total = cfg.array_slots * cfg.rows * cfg.columns
    rp = np.zeros((2, n_total))
    idx = 0
    for array in range(cfg.array_slots):
        a = -array
        for row in range(cfg.rows):
            for col in range(cfg.columns):
                rp[0, idx] = (-col * d - half + a * cfg.columns * d
                              + cfg.columns * cfg.array_slots * half)
                rp[1, idx] = row * d - cfg.rows * half + half
                idx += 1
    active, _ = active_microphones(cfg)
    return rp[:, active]


def active_microphones_fft(cfg: Config) -> tuple[np.ndarray, int]:
    """The FFT stack's own active-mic selection
    (``realtime_scripts/active_microphones.py:4-45``): the same
    block-hstack + decimation + deadmap logic as
    :func:`active_microphones`, but spanning ``ACTIVE_ARRAYS`` boards —
    NOT the ``array_slots`` the main ``directions.pyx`` model spans.
    Pairing the fft mic model with the main (slot-spanning) selection
    would index past the coordinates :func:`r_prime_fft` fills, silently
    steering those mics from the array origin."""
    mode = cfg.skip_n_mics
    rows = np.arange(0, cfg.rows, mode)
    columns = np.arange(0, cfg.columns * cfg.active_arrays, mode)
    arr_elem = cfg.rows * cfg.columns
    blocks = [
        np.arange(a * arr_elem, (a + 1) * arr_elem).reshape(cfg.rows,
                                                            cfg.columns)
        for a in range(cfg.active_arrays)
    ]
    microphones = np.hstack(blocks)
    unused = set(int(m) for m in cfg.unused_mics)
    active = [
        int(microphones[r, c])
        for r in rows
        for c in columns
        if int(microphones[r, c]) not in unused
    ]
    active = np.sort(np.asarray(active, dtype=np.int64))
    return active, len(active)


def r_prime_fft(cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """The FFT stack's own mic model (``realtime_scripts/calc_r_prime.py:
    9-24``), which diverges from ``directions.pyx``: the plane is lowered by
    the camera mount offset (``camera_offset``, line 7/18), boards are
    spread by ``ARRAY_SEPARATION`` (line 17) with a recentring shift of
    ``(ACTIVE_ARRAYS-1)*ARRAY_SEPARATION/2`` (line 20), and the layout loop
    runs over ``ACTIVE_ARRAYS`` (not the 4 physical slots).

    Returns ``(r_all (2, n_microphones), r_active (2, n_active))`` exactly
    like the reference's ``(r_prime_all, r_prime)`` pair.
    """
    d = cfg.element_distance
    half = d / 2
    sep = cfg.array_separation
    rp = np.zeros((2, cfg.n_microphones))
    idx = 0
    for array in range(cfg.active_arrays):
        a = -array
        for row in range(cfg.rows):
            for col in range(cfg.columns):
                rp[0, idx] = (-col * d - half + a * cfg.columns * d
                              + a * sep
                              + cfg.columns * cfg.active_arrays * half)
                rp[1, idx] = (row * d - cfg.rows * half + half
                              - cfg.camera_offset)
                idx += 1
    rp[0, :] += (cfg.active_arrays - 1) * sep / 2
    active, _ = active_microphones_fft(cfg)
    return rp, rp[:, active]


# ---------------------------------------------------------------------------
# Delay models
# ---------------------------------------------------------------------------

def calculate_delays(cfg: Config) -> np.ndarray:
    """Fractional sample delays (x_res, y_res, n_active), float64.

    The cartesian scanning-window model of ``directions.pyx:90-124``: a
    planar wavefront from each (x, y) point on a window at distance
    ``z_scan`` hits mic *i* early by ``(fs/c)·(x·xi + y·yi)/r_scan`` samples;
    delays are shifted so the furthest mic has zero delay (all delays >= 0).
    """
    c = cfg.propagation_speed
    fs = cfg.sample_rate
    rp = r_prime(cfg)
    x_i = rp[0, :]
    y_i = rp[1, :]

    x_scan_max = cfg.z_scan * np.tan((cfg.view_angle / 2) * np.pi / 180)
    y_scan_max = x_scan_max / cfg.aspect_ratio

    x_scan = np.linspace(-x_scan_max, x_scan_max, cfg.max_res_x).reshape(-1, 1, 1)
    y_scan = np.linspace(-y_scan_max, y_scan_max, cfg.max_res_y).reshape(1, -1, 1)
    r_scan = np.sqrt(x_scan**2 + y_scan**2 + cfg.z_scan**2)

    samp_delay = (fs / c) * (x_scan * x_i + y_scan * y_i) / r_scan
    samp_delay -= samp_delay.min(axis=2, keepdims=True)
    return samp_delay


def calculate_delays_angles(cfg: Config) -> np.ndarray:
    """Angle-grid delay model, (x_res, y_res, rows*columns*array_slots)
    float32 — the table behind the truncated algorithm.

    Mirrors ``directions.pyx:126-157`` EXACTLY, including its multi-board
    quirk: the reference fills only board 0's ``rows*columns`` entries
    with steering delays, then subtracts the per-pixel ``smallest`` from
    the WHOLE array — so every slot-1+ entry ends up at the constant
    ``-smallest`` (no steering), not a copy of the board-0 pattern.
    (Round-3 parity fix: this code used to replicate board 0 across
    slots, which the reference never does; the shared oracle made tests
    blind to it.)
    """
    d = cfg.element_distance
    half = d / 2.0
    n_per_board = cfg.rows * cfg.columns
    n_total = n_per_board * cfg.array_slots

    az = np.linspace(-cfg.max_angle, cfg.max_angle, cfg.max_res_x) * -np.pi / 180.0
    el = np.linspace(-cfg.max_angle, cfg.max_angle, cfg.max_res_y) * -np.pi / 180.0
    x_factor = np.sin(az).reshape(-1, 1, 1)
    y_factor = np.sin(el).reshape(1, -1, 1)

    col = np.arange(cfg.columns)
    row = np.arange(cfg.rows)
    tmp_col = col * d - cfg.columns * half + half          # (C,)
    tmp_row = row * d - cfg.rows * half + half             # (R,)
    pos = (tmp_col[None, :] * np.ones((cfg.rows, 1)),
           tmp_row[:, None] * np.ones((1, cfg.columns)))
    xs = pos[0].reshape(-1)    # (R*C,) ordered row*COLUMNS + col
    ys = pos[1].reshape(-1)

    delay = xs * x_factor + ys * y_factor                   # (X, Y, R*C)
    smallest = np.minimum(delay.min(axis=2, keepdims=True), 0.0)
    delay = delay - smallest
    delay = delay * (cfg.sample_rate / cfg.propagation_speed)

    out = np.zeros((cfg.max_res_x, cfg.max_res_y, n_total), dtype=np.float32)
    out[:, :, :n_per_board] = delay.astype(np.float32)
    if cfg.array_slots > 1:
        # reference quirk: slots 1+ were never written, so the global
        # `-= smallest` leaves them at the constant -smallest (scaled)
        const = (-smallest * (cfg.sample_rate / cfg.propagation_speed)
                 ).astype(np.float32)                  # (X, Y, 1)
        out[:, :, n_per_board:] = const
    return out


def calculate_delay_miso(cfg: Config, azimuth: float, elevation: float) -> np.ndarray:
    """Whole-sample delays for a single (azimuth, elevation) listen direction,
    int array over all board-slot mics.  Mirrors ``directions.pyx:159-187``
    EXACTLY, including its multi-board quirk: only board 0 gets steering
    delays; the global ``-= smallest`` leaves slots 1+ at the constant
    ``-smallest`` (scaled, truncated to int).  (Round-3 parity fix —
    this used to replicate board 0 across slots.)
    """
    d = cfg.element_distance
    half = d / 2.0
    x_factor = np.sin(azimuth * -np.pi / 180.0)
    y_factor = np.sin(elevation * -np.pi / 180.0)

    col = np.arange(cfg.columns)
    row = np.arange(cfg.rows)
    tmp_col = col * d - cfg.columns * half + half
    tmp_row = row * d - cfg.rows * half + half
    delay = (tmp_col[None, :] * x_factor + tmp_row[:, None] * y_factor).reshape(-1)
    smallest = min(delay.min(), 0.0)
    delay = (delay - smallest) * (cfg.sample_rate / cfg.propagation_speed)

    n_per_board = cfg.rows * cfg.columns
    out = np.zeros(n_per_board * cfg.array_slots, dtype=np.float64)
    out[:n_per_board] = delay
    # reference quirk: slots 1+ stay at 0 - smallest (scaled)
    out[n_per_board:] = -smallest * (cfg.sample_rate / cfg.propagation_speed)
    return out.astype(int)


# ---------------------------------------------------------------------------
# FIR fractional-delay designers
# ---------------------------------------------------------------------------

def get_h(frac_delay: np.ndarray, n_taps: int = 8) -> np.ndarray:
    """Windowed-sinc taps for fractional delays, vectorized.

    Mirrors ``directions.pyx:189-205`` (``get_h``): ``tau = -delay``;
    ``sinc = n - (N-1)/2 - (0.5 + tau) + eps``; Blackman window with the
    reference's literal ``/N`` periodic parametrization; unity-gain
    normalized.  Input shape (...,) -> output (..., n_taps).
    """
    frac_delay = np.asarray(frac_delay, dtype=np.float64)
    eps = 1e-9
    n = np.arange(n_taps, dtype=np.float64)
    tau = -frac_delay[..., None]
    sinc = n - (n_taps - 1) / 2 - (0.5 + tau) + eps
    h = np.sin(sinc * np.pi) / (sinc * np.pi)
    blackman = (0.42 - 0.5 * np.cos(2 * np.pi * n / n_taps)
                + 0.08 * np.cos(4 * np.pi * n / n_taps))
    h = h * blackman
    h = h / np.sum(h, axis=-1, keepdims=True)
    return h


def get_h2(delay: np.ndarray, n_taps: int = 64) -> np.ndarray:
    """Windowed-sinc taps supporting whole-frame delays up to n_taps/2.

    Mirrors ``directions.pyx:207-226`` (``get_h2``): ``tau = 0.5 - delay +
    eps``; symmetric Blackman over ``n = 2i - N + 1``.  Vectorized:
    (...,) -> (..., n_taps).
    """
    delay = np.asarray(delay, dtype=np.float64)
    eps = 1e-9
    i = np.arange(n_taps, dtype=np.float64)
    tau = 0.5 - delay[..., None] + eps
    hi = i - (n_taps - 1) / 2 - tau
    h = np.sin(hi * np.pi) / (hi * np.pi)
    n = i * 2 - n_taps + 1
    black = (0.42 + 0.5 * np.cos(np.pi * n / (n_taps - 1 + eps))
             + 0.08 * np.cos(2 * np.pi * n / (n_taps - 1 + eps)))
    h = h * black
    h = h / np.sum(h, axis=-1, keepdims=True)
    return h


def compute_h_convolve(delay: np.ndarray, n_taps: int = 8) -> np.ndarray:
    """The C-side kernel designer, ``hybrid_convolve_and_sum.c:124-157``.

    Same family as :func:`get_h2` but with the C code's epsilon placement
    quirks reproduced verbatim (first cosine has ``+eps`` inside its
    argument; second has ``+eps`` in the denominator), so tables match the
    reference bit-for-bit at float32.
    """
    delay = np.asarray(delay, dtype=np.float64)
    eps = 1e-9
    i = np.arange(n_taps, dtype=np.float64)
    tau = 0.5 - delay[..., None] + eps
    hi = i - (n_taps - 1.0) / 2.0 - tau
    h = np.sin(hi * np.pi) / (hi * np.pi)
    n = i * 2 - n_taps + 1
    black = (0.42 + 0.5 * np.cos(np.pi * n / (n_taps - 1.0) + eps)
             + 0.08 * np.cos(2.0 * np.pi * n / (n_taps - 1.0 + eps)))
    h = h * black
    h = h / np.sum(h, axis=-1, keepdims=True)
    return h


# ---------------------------------------------------------------------------
# Per-algorithm coefficient tables
# ---------------------------------------------------------------------------

def calculate_coefficients(cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """(whole int64 (X,Y,n), h float32 (X,Y,n,8)) — ``directions.pyx:260-277``.

    ``whole`` is the integer part of the cartesian delays, ``h`` the 8-tap
    :func:`get_h` bank of the fractional remainders (used by the pad
    algorithm for its whole part only).
    """
    samp_delay = calculate_delays(cfg)
    whole = samp_delay.astype(int)
    frac = samp_delay - whole
    h = get_h(frac, 8).astype(np.float32)
    return whole, h


def lerp_coefficients(cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """(whole int (X,Y,n), h float32 (X,Y,n)) for the lerp beamformer.

    ``load_coefficients_lerp`` (``lerp_and_sum.c:139-153``) splits delays via
    ``modf`` and stores ``h := 1 - frac`` (the interpolation runs as
    ``out[pad+i+1] += s[i] + h*(s[i+1]-s[i])``).
    """
    samp_delay = calculate_delays(cfg).astype(np.float32)  # C receives float32
    samp_delay = samp_delay.astype(np.float64)
    whole = np.floor(samp_delay)
    frac = samp_delay - whole
    h = (1.0 - frac).astype(np.float32)
    return whole.astype(int), h


def convolve_coefficients(cfg: Config) -> np.ndarray:
    """Full-delay FIR bank (X,Y,n,n_taps) float32 — ``compute_convolve_h``
    (``directions.pyx:229-254``): :func:`get_h2` applied to the *unsplit*
    cartesian delay (the pure convolve beamformer can only realize delays up
    to n_taps/2; kept for parity)."""
    samp_delay = calculate_delays(cfg)
    return get_h2(samp_delay, cfg.n_taps).astype(np.float32)


def hybrid_coefficients(cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """(whole int (X,Y,n), taps float32 (X,Y,n,n_taps)) for hybrid convolve.

    ``load_coefficients_convolve_hybrid`` (``hybrid_convolve_and_sum.c:
    161-180``): integer part via ``modf``; taps designed by the C
    ``compute_h_convolve`` on the *reversed* fraction ``1 - frac``.
    """
    samp_delay = calculate_delays(cfg).astype(np.float32).astype(np.float64)
    whole = np.floor(samp_delay)
    frac = 1.0 - (samp_delay - whole)
    taps = compute_h_convolve(frac, cfg.n_taps).astype(np.float32)
    return whole.astype(int), taps


# ---------------------------------------------------------------------------
# FFT-domain steering (phase-shift) tensor
# ---------------------------------------------------------------------------

def phase_shift_tensor(
    cfg: Config,
    freq_low: float | None = None,
    freq_high: float | None = None,
    mic_model: str | None = None,
) -> tuple[np.ndarray, tuple[int, int]]:
    """Complex narrowband steering tensor for the FFT-domain beamformer.

    Mirrors ``calc_phase_shift_cartesian.py:44-50``: for every rfft bin in
    [freq_low, freq_high) and every active mic, the phase advance toward each
    (x, y) scan point: ``exp(-j·k·(x·xi + y·yi)/r_scan)``.

    ``mic_model`` selects the coordinates (default ``cfg.fft_mic_model``):
    ``"main"`` = the directions.pyx geometry; ``"fft"`` = the FFT stack's
    own :func:`r_prime_fft` with camera offset / array separation —
    required to reproduce web backend-3 as shipped
    (use ``Config.fft_reference()``).

    Returns ``(phase (F, M, X, Y) complex64, (lo_idx, hi_idx))`` where
    lo/hi are the rfft bin bounds selected.
    """
    if freq_low is None:
        freq_low = cfg.freq_band_low
    if freq_high is None:
        freq_high = (cfg.freq_band_high if cfg.freq_band_high > 0
                     else cfg.sample_rate / 2)
    if mic_model is None:
        mic_model = cfg.fft_mic_model
    if mic_model == "fft":
        _, rp = r_prime_fft(cfg)
    else:
        rp = r_prime(cfg)
    x_i = rp[0, :].reshape(1, -1, 1, 1)
    y_i = rp[1, :].reshape(1, -1, 1, 1)

    x_scan_max = cfg.z_scan * np.tan(np.deg2rad(cfg.view_angle / 2))
    y_scan_max = x_scan_max / cfg.aspect_ratio
    x_scan = np.linspace(-x_scan_max, x_scan_max, cfg.max_res_x).reshape(1, 1, -1, 1)
    y_scan = np.linspace(-y_scan_max, y_scan_max, cfg.max_res_y).reshape(1, 1, 1, -1)
    r_scan = np.sqrt(x_scan**2 + y_scan**2 + cfg.z_scan**2)

    f = np.linspace(0, cfg.sample_rate / 2, cfg.n_samples // 2 + 1)
    lo = int(np.abs(f - freq_low).argmin())
    hi = int(np.abs(f - freq_high).argmin())
    fsel = f[lo:hi].reshape(-1, 1, 1, 1)
    k = 2 * np.pi * fsel / cfg.propagation_speed

    phase = np.exp(1j * (-k * (x_scan * x_i + y_scan * y_i) / r_scan))
    return phase.astype(np.complex64), (lo, hi)
