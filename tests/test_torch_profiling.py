"""The port's profiling, timer and provenance helpers (``utils/``) on the
CPU: ``trace`` writes a Chrome trace, every device timer refuses a host or
device without CUDA (no wall-clock fallback), ``Timer`` counts, and the
provenance sidecar round-trips with the JAX package's fingerprint, blind to
the volatile keys."""

import json
import os

import pytest
import torch

from tpu3dsis.config import cfg_from_file as jax_cfg_from_file
from tpu3dsis.config import finalize_config as jax_finalize_config
from tpu3dsis.utils import provenance as jax_provenance
from tpu3dsis_torch.config import cfg_from_file, finalize_config
from tpu3dsis_torch.utils import profiling, provenance
from tpu3dsis_torch.utils.timer import Timer


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        x = torch.randn(64, 64)
        (x @ x).relu().sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) or "mm" in str(e.get("name", "")) for e in events)
    assert any(e.key in ("aten::matmul", "aten::mm") for e in prof.key_averages())


@pytest.mark.parametrize("timer", ["device_time", "device_ms", "cuda_ms", "host_ms"])
def test_device_timers_refuse_the_cpu(timer, monkeypatch):
    fn = getattr(profiling, timer)
    calls = []
    args = (lambda: calls.append(1), 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)
    if timer == "device_time":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(RuntimeError, match="not a CUDA device"):
            fn(*args, device="cpu")
    assert not calls  # refused before the first call


def test_timer_counts_and_syncs():
    t = Timer()
    for _ in range(3):
        t.tic(sync=torch.ones(2))
        avg = t.toc(sync=torch.ones(2))
    assert t.calls == 3 and avg == pytest.approx(t.total_time / 3) and t.toc(average=False) >= 0
    assert t.calls == 4


def _cfgs():
    port = cfg_from_file("experiments/cfgs/ScanNet/benchmark.yml")
    finalize_config(port)
    jax = jax_cfg_from_file("experiments/cfgs/ScanNet/benchmark.yml")
    jax_finalize_config(jax)
    return port, jax


def test_provenance_round_trips_and_ignores_volatile_keys(tmp_path):
    port, jax = _cfgs()
    assert provenance.config_fingerprint(port) == jax_provenance.config_fingerprint(jax)
    base = provenance.config_fingerprint(port)
    for key, value in (("TRAIN_FILELIST", "elsewhere.txt"), ("BASE_IMAGE_PATH", "/x/frames_square"),
                       ("TEST_SAVE_DIR", "out"), ("MODE", "test")):
        changed = port.copy()
        changed[key] = value
        assert provenance.config_fingerprint(changed) == base, key
    changed = port.copy()
    changed.LEARNING_RATE = 0.5
    assert provenance.config_fingerprint(changed) != base
    fixture = str(tmp_path / "params.npz")
    path = provenance.write_provenance(fixture, "python -m x --steps 2", port, {"steps": 2, "lr": 0.003},
                                       note="a test")
    assert path == fixture + ".provenance.json" and os.path.isfile(path)
    got = provenance.read_provenance(fixture)
    assert got == {"fixture": "params.npz", "command": "python -m x --steps 2", "args": {"lr": 0.003, "steps": 2},
                   "config_fingerprint": base, "dtype": "float16 (savez_compressed)", "note": "a test"}
    jax_path = jax_provenance.write_provenance(str(tmp_path / "jax.npz"), "python -m x --steps 2", jax,
                                               {"steps": 2, "lr": 0.003}, note="a test")
    with open(jax_path) as f:
        assert {**json.load(f), "fixture": "params.npz"} == got
