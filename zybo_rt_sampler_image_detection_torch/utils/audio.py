"""Audio output sinks for the steered MISO beam.

The reference plays the beam through PortAudio from a fork'd C child
(``api.c:268-427``) or PyAudio (``PC/play.py``).  Neither needs to be
installed, so the playback engine is an abstract sink with these backends:

* :class:`SoundDeviceSink`  — live playback when ``sounddevice`` exists;
* :class:`WavFileSink`      — stdlib ``wave`` writer (always available);
* :class:`MockCallbackSink` — a wall-clock consumer that counts underflow;
* :class:`NullSink`         — drop samples, keep timing (benchmarks).

The MISO gain chain matches ``miso_loop`` (``api.c:491-543``): beam/n *
MIC_GAIN, then clipped to [-1, 1] for the device.

A copy of ``zybo_rt_sampler_image_detection_tpu/utils/audio.py`` (NumPy
and the standard library only); the port keeps its own so that it never
imports the JAX package.
"""

from __future__ import annotations

import queue
import threading
import wave
from typing import Optional

import numpy as np


class AudioSink:
    def write(self, samples: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(AudioSink):
    def __init__(self):
        self.frames = 0

    def write(self, samples: np.ndarray) -> None:
        self.frames += samples.shape[0]


class WavFileSink(AudioSink):
    """Stdlib ``wave`` writer fed through a dedicated writer thread.

    A synchronous disk write inside the real-time stage thread can stall
    for tens of ms on a contended host and starve the line-rate pipeline,
    so :meth:`write` only enqueues the int16 chunk; the writer thread
    streams it to disk (coalescing whatever is pending into one
    ``writeframes`` call).  This keeps memory bounded on long runs and
    the file a recoverable sample stream at all times — an earlier
    buffer-everything-write-at-close design lost the whole capture on an
    unclean exit.  Writes after :meth:`close` (or after a disk-write
    failure) are dropped and counted in ``_dropped`` — a stage thread
    that outlives the pipeline's bounded join must not die on them."""

    def __init__(self, path: str, sample_rate: float):
        self._rate = int(round(sample_rate))
        self._wave = wave.open(path, "wb")
        self._wave.setnchannels(1)
        self._wave.setsampwidth(2)
        self._wave.setframerate(self._rate)
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        self._failed = False
        self._dropped = 0                 # late/post-failure writes
        # serializes enqueue vs the close() sentinel: without it a
        # write() racing close() can land its chunk AFTER the sentinel,
        # where the writer never sees it and _dropped never counts it
        self._lock = threading.Lock()
        self._writer = threading.Thread(target=self._drain,
                                        name="wav-writer", daemon=True)
        self._writer.start()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            parts = []
            while item is not None:
                parts.append(item)
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
            if parts:
                try:
                    self._wave.writeframes(b"".join(parts))
                except Exception:
                    # disk full / EIO: record the failure so write()
                    # stops feeding the queue (otherwise a long run
                    # grows host memory unboundedly while the capture
                    # silently stops), then keep draining sentinels
                    self._failed = True
                    import logging
                    logging.getLogger(__name__).exception(
                        "WavFileSink: disk write failed; dropping "
                        "further audio")
            if item is None:
                return

    def write(self, samples: np.ndarray) -> None:
        if self._closed or self._failed:
            # late writes happen when a stage thread outlives
            # Pipeline.stop's bounded join (a device stall) — drop,
            # don't kill the stage with an exception
            self._dropped += 1
            return
        clipped = np.clip(samples, -1.0, 1.0)
        data = (clipped * 32767).astype("<i2").tobytes()
        with self._lock:
            if self._closed:              # lost the race with close()
                self._dropped += 1
                return
            self._q.put(data)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._writer.join(timeout=30.0)
        if self._writer.is_alive():       # pragma: no cover
            # writer stuck in a blocked writeframes (NFS stall, full
            # disk): closing the wave object under it would race the
            # active write and truncate the header — leave the handle
            # to the daemon thread / process exit
            import logging
            logging.getLogger(__name__).warning(
                "WavFileSink: writer did not drain within 30s; leaving "
                "the file open (%d chunks may be unflushed)",
                self._q.qsize())
            return
        try:
            self._wave.close()
        except OSError:
            # close() patches the RIFF header on the same filesystem
            # that just failed a data write (full disk, I/O error) —
            # the sink's contract is to survive disk failure, and
            # raising here would abort the caller's teardown
            # (Pipeline.stop ends with sink.close())
            import logging
            logging.getLogger(__name__).warning(
                "WavFileSink: header patch failed on close; the capture "
                "may be truncated", exc_info=True)


class MockCallbackSink(AudioSink):
    """Deadline-accounting stand-in for a PortAudio callback output.

    The reference feeds a PortAudio callback ring at line rate
    (``api.c:268-282``); on a host without audio hardware this sink
    models the device side: a wall-clock consumer drains the buffer at
    ``sample_rate`` starting ``prefill_ms`` after the first write.  Any
    demand the writes have not covered yet counts as underflow samples
    (the silence a real callback would have emitted).  Lets tests and
    the demo measure whether the pipeline would keep a live audio
    device fed, without sounddevice."""

    def __init__(self, sample_rate: float, prefill_ms: float = 50.0):
        import time
        self._clock = time.perf_counter
        self.rate = float(sample_rate)
        self.prefill = int(self.rate * prefill_ms / 1e3)
        self.written = 0
        self.underflow_samples = 0
        self._t0 = None

    def write(self, samples: np.ndarray) -> None:
        n = int(np.asarray(samples).shape[0])
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        demand = max(0, int((now - self._t0) * self.rate) - self.prefill)
        if demand > self.written:
            # the callback already played silence for these samples; the
            # stream continues from the live edge (PortAudio semantics)
            self.underflow_samples += demand - self.written
            self.written = demand
        self.written += n

    @property
    def underflow_ms(self) -> float:
        return 1e3 * self.underflow_samples / self.rate


class SoundDeviceSink(AudioSink):                     # pragma: no cover
    def __init__(self, sample_rate: float):
        import sounddevice as sd
        self._stream = sd.OutputStream(
            samplerate=int(round(sample_rate)), channels=1, dtype="float32")
        self._stream.start()

    def write(self, samples: np.ndarray) -> None:
        self._stream.write(np.clip(samples, -1, 1).astype(np.float32))

    def close(self) -> None:
        self._stream.stop()
        self._stream.close()


def make_sink(kind: str, sample_rate: float,
              path: Optional[str] = None) -> AudioSink:
    if kind == "null":
        return NullSink()
    if kind == "wav":
        return WavFileSink(path or "miso.wav", sample_rate)
    if kind == "sounddevice":
        return SoundDeviceSink(sample_rate)
    if kind == "mock":
        return MockCallbackSink(sample_rate)
    if kind == "auto":
        try:
            return SoundDeviceSink(sample_rate)
        except Exception:
            return WavFileSink(path or "miso.wav", sample_rate)
    raise ValueError(f"unknown audio sink {kind!r}")


def miso_gain(beam: np.ndarray, n_mics: int, mic_gain: float,
              norm_sound: Optional[float] = None) -> np.ndarray:
    """``api.c:517-522``: out = beam / n * MIC_GAIN."""
    out = beam / float(n_mics) * float(mic_gain)
    if norm_sound:
        out = out / norm_sound
    return out
