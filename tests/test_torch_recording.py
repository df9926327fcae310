"""The port's recording and profiling utilities (``utils/recording.py``,
``utils/profiling.py``) and the demos that use them, on the CPU:

* the ``.npy`` capture through the live replay loop (the JAX package's
  ``tests/test_recording.py``), and ``record_udp_to_pcap`` read back;
* ``get_recording``'s skip policies on a fake receiver, equal to the JAX
  package's;
* a profiler trace writes its Chrome trace with the annotated ranges;
  the spans' aggregate (``profiling.report``);
* ``demo sensorfusion --pretrain 20 --device cpu`` and ``demo record
  --device cpu`` exit 0.

UDP 22170-22173."""

import glob
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_tpu.utils import recording as jrecording
from zybo_rt_sampler_image_detection_torch.apps import demo
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ingest import (
    protocol, receiver, streamer)
from zybo_rt_sampler_image_detection_torch.utils import profiling, recording

torch.set_num_threads(2)


def _frames(cfg, n, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((cfg.n_microphones, cfg.n_samples)) * 0.1
             ).astype(np.float32) for _ in range(n)]


def test_npy_recording(tmp_path):
    cfg = Config.tiny().replace(udp_port=22170)
    # 12 distinct frames cycled for a long window: a host stall under the
    # suite's load must not let the stream end before 3 frames are read
    frames = _frames(cfg, 12) * 40
    r = receiver.Receiver(cfg, replay_mode=True, backend="python",
                          exact_reference=False)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.3,
                                  exact_reference=False,
                                  rate=4 * cfg.sample_rate)
    r.connect(timeout=5.0)
    seconds = 3 * cfg.n_samples / cfg.sample_rate
    try:
        path = recording.record_npy(r, seconds, str(tmp_path / "cap.npy"))
    finally:
        r.disconnect()
    rec = np.load(path)
    assert rec.shape[0] == cfg.n_microphones
    assert rec.shape[1] >= 3 * cfg.n_samples
    assert rec.dtype == np.float32
    # every recorded frame is one of the streamed frames, or an all-zero
    # frame that get_recording inserted for a frame the consumer missed
    matched = 0
    for i in range(rec.shape[1] // cfg.n_samples):
        chunk = rec[:, i * cfg.n_samples:(i + 1) * cfg.n_samples]
        if not chunk.any():
            continue
        errs = [np.abs(chunk - f).max() for f in frames[:12]]
        assert min(errs) < 2.0 / cfg.norm_factor
        matched += 1
    assert matched >= 1


def test_udp_pcap_capture(tmp_path):
    """``record_udp_to_pcap`` binds the port, captures the datagrams and
    their counters; the pcap reads back packet for packet."""
    cfg = Config.tiny().replace(udp_port=22173)
    stop = threading.Event()

    def frames():
        for f in _frames(cfg, 6) * 50:
            if stop.is_set():
                return
            yield f

    streamer.stream_in_background(cfg, frames(), n_arrays=1, delay=0.3,
                                  exact_reference=False,
                                  rate=cfg.sample_rate)
    path, csv_path = str(tmp_path / "cap.pcap"), str(tmp_path / "ts.csv")
    try:
        n = recording.record_udp_to_pcap(cfg, 1.0, path,
                                         timestamps_csv=csv_path)
    finally:
        stop.set()
    assert n > 0
    payloads = [p for _, p in protocol.read_pcap(path)]
    assert len(payloads) == n
    assert all(len(p) == protocol.packet_size(cfg) for p in payloads)
    with open(csv_path) as f:
        rows = f.read().strip().splitlines()
    assert rows[0] == "index,timestamp,counter" and len(rows) == n + 1
    counters = [int(r.split(",")[2]) for r in rows[1:]]
    assert counters == [protocol.unpack_header(p)[3] for p in payloads]


class _FakeReceiver:
    """Publishes seq 1, 2, then jumps to 5 (frames 3-4 missed)."""
    cfg = Config.tiny()

    def __init__(self):
        self.seqs = iter([1, 2, 5, 6, 7, 8])

    def read_frame(self, fresh=True, last_seq=0, timeout=None):
        seq = next(self.seqs)
        f = np.full((self.cfg.n_microphones, self.cfg.n_samples),
                    float(seq), np.float32)
        return f, seq


@pytest.mark.parametrize("policy,expect", [
    ("zero", [1.0, 2.0, 0.0, 0.0, 5.0]),
    ("ignore", [1.0, 2.0, 5.0, 6.0, 7.0]),
])
def test_get_recording_skip_policies(policy, expect):
    """Missed frames are found from the sequence counter: 'zero' inserts
    zero frames and warns, 'ignore' concatenates what arrived; both equal
    the JAX package's ``get_recording`` on the same receiver."""
    T = _FakeReceiver.cfg.n_samples
    seconds = 5 * T / _FakeReceiver.cfg.sample_rate
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rec = recording.get_recording(_FakeReceiver(), seconds,
                                      on_skip=policy)
    assert any("missed" in str(x.message) for x in w) == (policy == "zero")
    assert [rec[0, i * T] for i in range(5)] == expect
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jrecording.get_recording(_FakeReceiver(), seconds,
                                       on_skip=policy)
    np.testing.assert_array_equal(rec, ref)


def test_get_recording_raise_policy():
    seconds = 5 * _FakeReceiver.cfg.n_samples / _FakeReceiver.cfg.sample_rate
    with pytest.raises(RuntimeError, match="not contiguous"):
        recording.get_recording(_FakeReceiver(), seconds, on_skip="raise")


def test_profiler_trace_writes_artifacts(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with profiling.trace(logdir) as d:
        assert d == logdir
        with profiling.annotate("matmul_region"):
            y = (x @ x).sum()
    assert torch.isfinite(y)
    files = glob.glob(f"{logdir}/trace_*.json")
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "matmul_region" in names
    assert any("mm" in str(n) for n in names)


def test_stopwatch(tmp_path):
    """The spans' aggregate (``profiling.report``, which took the
    Stopwatch's place): a name's count, total and longest span, while a
    profiler records."""
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            with profiling.annotate("work"):
                time.sleep(0.002)
    rep = profiling.report()
    assert rep["work"]["n"] == 3
    assert rep["work"]["total_s"] >= 0.005
    assert rep["work"]["max_s"] >= 0.0015
    assert rep["work"]["self_s"] == rep["work"]["total_s"]


def _stream(cfg):
    stop = threading.Event()

    def gen():
        rng = np.random.default_rng(5)
        base = (rng.standard_normal((cfg.n_microphones, cfg.n_samples))
                * 0.05).astype(np.float32)
        for i in range(5000):
            if stop.is_set():
                return
            yield (base * (1.0 + 0.01 * (i % 50))).astype(np.float32)

    streamer.stream_in_background(cfg, gen(), n_arrays=1, delay=0.5,
                                  rate=cfg.sample_rate / 16)
    return stop


def test_demo_sensorfusion_pretrain(tmp_path, monkeypatch, capsys):
    """``--pretrain 20`` trains the demo detector 20 steps on the CPU,
    caches it under ``$HOME/.cache`` and runs the fused demo on it."""
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = Config.tiny().replace(udp_port=22171)
    stop = _stream(cfg)
    try:
        rc = demo.main(["sensorfusion", "--replay", "--preset", "tiny",
                        "--port", "22171", "--headless", "--device", "cpu",
                        "--backend", "python", "--frames", "4", "--width",
                        "160", "--height", "96", "--out", "",
                        "--camera", "-2", "--pretrain", "20"])
    finally:
        stop.set()
    out = capsys.readouterr().out
    assert rc == 0, out
    assert (tmp_path / ".cache" / "zrt_demo_detector_torch.pkl").exists()


def test_demo_record(tmp_path, capsys):
    cfg = Config.tiny().replace(udp_port=22172)
    stop = _stream(cfg)
    out = str(tmp_path / "rec.npy")
    try:
        rc = demo.main(["record", "--replay", "--preset", "tiny", "--port",
                        "22172", "--device", "cpu", "--backend", "python",
                        "--seconds", "0.05", "--out", out])
    finally:
        stop.set()
    assert rc in (None, 0)
    rec = np.load(out)
    n_frames = int(np.ceil(0.05 * cfg.sample_rate / cfg.n_samples))
    assert rec.shape == (cfg.n_microphones, n_frames * cfg.n_samples)
    assert rec.dtype == np.float32 and rec.any()
    assert "recorded" in capsys.readouterr().out
