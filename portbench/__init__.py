"""The benchmark of ``zybo_rt_sampler_image_detection_torch`` on one GPU.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix)::

    python3 -m portbench.run --workload cfgjson.replay --seed 7 \\
        --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix, traffic
driver or per-layer metric is a file of its own, found by its name:
``configs/<name>.json``, ``traffic/<name>.json``, ``drivers/<kind>.py``
and ``metrics/<name>.py``; the check of a configuration's outputs is its
algorithm's plain reference, ``references/<algorithm>.py``, and the
comparisons its limits name, ``checks/<name>.py``.  The yardstick (signal
generation, the float64 references, the roofline counts and the trace
reduction) lives here too, and imports nothing of the measured package.
"""
