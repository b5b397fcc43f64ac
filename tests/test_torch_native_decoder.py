"""The port's native chunk decoder (``csrc/chunk_decoder.cpp``, built with
g++ by ``_build.build_host``; ``runtime/native.py``) and its fast path,
``io/dataset.py::load_fast_padded``, against the numpy path and the JAX
package's ``load_fast_padded``; the loader's batches on both paths; the
build under concurrent processes and its failure."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpu3dsis.config import default_config as jax_default_config
from tpu3dsis.io.dataset import SceneDataset as JaxSceneDataset
from tpu3dsis.io.dataset import load_fast_padded as jax_load_fast_padded
from tpu3dsis.io.dataset import pad_sample as jax_pad_sample
from tpu3dsis_torch import _build
from tpu3dsis_torch.config import default_config
from tpu3dsis_torch.io import write_chunk_file
from tpu3dsis_torch.io.dataset import SceneDataset, encode_tsdf, load_fast_padded, pad_sample, paint_mask_canvas
from tpu3dsis_torch.io.pipeline import PrefetchLoader
from tpu3dsis_torch.runtime import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABEL_MAP = "experiments/labelmaps/nyu40labels_scannet.csv"


def _cfg(make=default_config, **changes):
    cfg = make()
    cfg.update(LABEL_MAP=LABEL_MAP, KEEP_THRESH=1.0, TPU_MAX_GT=8, NUM_CLASSES=19, **changes)
    return cfg


def _write(path, rng, dims=(96, 56, 96), boxes=((4.2, 3.1, 5.4, 20.0, 21.7, 22.2),), labels=None, mask_dims=None):
    """A chunk with random TSDF values (some beyond the truncation) and
    random masks, some values above 1, their dims each box's floor/ceil
    extent unless ``mask_dims`` says otherwise."""
    sdf = (rng.randn(*dims) * 2).astype(np.float32)
    boxes = np.asarray(boxes, np.float64).reshape(-1, 6)
    masks = []
    for i, b in enumerate(boxes):
        shape = tuple(int(np.ceil(b[k + 3]) - np.floor(b[k])) for k in range(3))
        masks.append((rng.rand(*(mask_dims or shape)) * 2.4).astype(np.uint16))
    labels = np.asarray(labels if labels is not None else [5, 7, 39, 3, 4][:len(boxes)], np.uint32)
    write_chunk_file(path, sdf, boxes, labels, masks, np.ones(len(boxes), np.float32),
                     np.eye(4, dtype=np.float32) + 0.01, np.array([2, 9], np.uint32))
    return sdf, boxes, masks


def test_build_is_hashed_and_cached():
    lib = native.load_library()
    path = _build._library_path(native.SOURCE, _build.HOST_CXX_FLAGS, ())
    assert path.exists() and path.parent == _build.BUILD_DIR and path.name.startswith("libchunk_decoder_")
    assert _build.build_host(native.SOURCE) == path and lib is native.load_library()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_decode_matches_numpy(tmp_path, mode):
    """The three encodings (plain, FLIP, LOG), boxes, labels, fractions,
    the raw matrix, frame ids and the mask canvas."""
    path = str(tmp_path / "a.chunk")
    sdf, boxes, masks = _write(path, np.random.RandomState(mode), dims=(12, 8, 10),
                               boxes=((1.2, 1.1, 1.3, 5.8, 4.2, 6.9), (3.0, 2.0, 2.0, 9.0, 7.0, 8.0)))
    cfg = default_config()
    cfg.FLIP_TSDF, cfg.LOG_TSDF = mode == 1, mode == 2
    out = native.decode_chunk_native(path, float(cfg.TRUNCATED), mode)
    want = encode_tsdf(sdf, cfg)
    if mode == 2:  # C's log against numpy's: within an ulp
        np.testing.assert_allclose(out["data"], want, rtol=1e-6)
    else:
        assert np.array_equal(out["data"], want)
    assert np.array_equal(out["boxes"], boxes.astype(np.float32))
    assert np.array_equal(out["labels"], [5, 7]) and np.array_equal(out["frame_ids"], [2, 9])
    assert np.array_equal(out["fractions"], [1, 1])
    assert np.array_equal(out["world2chunk_raw"], np.eye(4, dtype=np.float32) + 0.01)  # the file's matrix, as written
    ds = SceneDataset.__new__(SceneDataset)
    ds.mode, ds.cfg, ds.mapping, ds.weights = "chunk", cfg, None, None
    assert np.array_equal(out["mask_canvas"], paint_mask_canvas(ds.load(path)))
    assert native.decode_chunk_native(path, 3.0, mode, with_canvas=False)["mask_canvas"] is None


def test_fast_path_matches_numpy_and_jax(tmp_path):
    """``load_fast_padded`` equals the port's and the JAX package's numpy
    path (``pad_sample``), and the JAX package's own fast path where its
    library builds, array for array."""
    path = str(tmp_path / "f.chunk")
    _write(path, np.random.RandomState(0), boxes=((4.2, 3.1, 5.4, 20.0, 21.7, 22.2), (30, 2, 40, 44, 30, 52)))
    (tmp_path / "l.txt").write_text(path + "\n")
    cfg, jcfg = _cfg(), _cfg(jax_default_config)
    ds, jds = SceneDataset(str(tmp_path / "l.txt"), "chunk", cfg), JaxSceneDataset(str(tmp_path / "l.txt"), "chunk",
                                                                                    jcfg)
    fast = load_fast_padded(ds, path, cfg)
    refs = [pad_sample(ds[0], cfg), jax_pad_sample(jds[0], jcfg)]
    jax_fast = jax_load_fast_padded(jds, path, jcfg)
    if jax_fast is not None:
        refs.append(jax_fast)
    for ref in refs:
        assert sorted(fast) == sorted(ref)
        for k in fast:
            assert fast[k].dtype == ref[k].dtype and np.array_equal(fast[k], ref[k]), k


DECLINED = {
    "filtered_by_keep_thresh": {"boxes": ((-6.0, 3.0, 5.0, 10.0, 20.0, 22.0),)},
    "no_boxes": {"boxes": np.zeros((0, 6))},
    "more_than_max_gt": {"boxes": [(2 + 9 * i, 3, 5, 8 + 9 * i, 12, 11) for i in range(9)], "labels": [5] * 9},
    "above_the_height_crop": {"boxes": ((4.0, 40.0, 5.0, 20.0, 52.0, 22.0),)},
    "mask_dims_differ": {"boxes": ((4.0, 3.0, 5.0, 20.0, 21.0, 22.0),), "mask_dims": (16, 18, 20)},
}


@pytest.mark.parametrize("case", sorted(DECLINED) + ["use_images"])
def test_fast_path_declines_where_numpy_decides(tmp_path, case):
    """None where the numpy path must decide: a box filtered, none, more
    than TPU_MAX_GT, above the height crop, a mask not of its box's extent,
    frames. The loader then serves what the numpy path makes of it."""
    path = str(tmp_path / "d.chunk")
    _write(path, np.random.RandomState(1), **DECLINED.get(case, {}))
    (tmp_path / "l.txt").write_text(path + "\n")
    cfg = _cfg(USE_IMAGES=case == "use_images")
    ds = SceneDataset(str(tmp_path / "l.txt"), "chunk", cfg)
    assert load_fast_padded(ds, path, cfg) is None
    if case == "use_images":
        return
    batches = [list(PrefetchLoader(ds, cfg, 1, shuffle=False, native=native_)) for native_ in (True, False)]
    # the numpy path keeps these two; it drops every box of the others, and so the sample
    assert len(batches[0]) == len(batches[1]) == (case in ("more_than_max_gt", "mask_dims_differ"))
    for a, b in zip(*batches):
        assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)


def test_loader_batches_equal_on_both_paths(tmp_path):
    """The loader with the native decoder and with numpy only: the same
    batches, in order, with a malformed file skipped on both."""
    rng = np.random.RandomState(3)
    paths = []
    for i in range(7):
        path = str(tmp_path / f"c{i}.chunk")
        _write(path, rng, dims=(40, 50, 36), boxes=((2 + i, 3, 4, 14 + i, 20, 18), (20, 1.5, 6.5, 33, 47, 30)))
        paths.append(path)
    with open(paths[4], "rb") as f:
        blob = f.read()
    with open(paths[4], "wb") as f:
        f.write(blob[:len(blob) // 3])
    with pytest.raises(EOFError):
        native.decode_chunk_native(paths[4], 3.0)
    (tmp_path / "l.txt").write_text("".join(p + "\n" for p in paths))
    cfg = _cfg(TPU_COMPACT_TRANSFERS=True)
    ds = SceneDataset(str(tmp_path / "l.txt"), "chunk", cfg)
    runs = [list(PrefetchLoader(ds, cfg, 2, shuffle=True, seed=5, num_workers=3, native=n)) for n in (True, False)]
    assert len(runs[0]) == len(runs[1]) == 3
    for a, b in zip(*runs):
        assert sorted(a) == sorted(b) and a["mask_canvas"].dtype == b["mask_canvas"].dtype
        for k in a:
            assert np.array_equal(a[k].numpy(), b[k].numpy()), k


_BUILD = """
import sys
from pathlib import Path
from tpu3dsis_torch import _build
_build.BUILD_DIR = Path(sys.argv[1])
print(_build.build_host(_build.CSRC / "chunk_decoder.cpp"))
"""


def test_build_is_safe_in_concurrent_processes(tmp_path):
    """Six processes build the library into one empty directory at once:
    each gets the same path, one library is left and no temporary file."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-500:] for o in outs]
    assert len({o[0].strip() for o in outs}) == 1
    assert [f.name for f in tmp_path.iterdir()] == [os.path.basename(outs[0][0].strip())]


def test_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that fails raises, in the build and in the loader before
    any file is read: no quiet numpy path."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host build failed"):
        _build.build_host(native.SOURCE)
    path = str(tmp_path / "c.chunk")
    _write(path, np.random.RandomState(4))
    (tmp_path / "l.txt").write_text(path + "\n")
    cfg = _cfg()
    native.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="host build failed"):
            list(PrefetchLoader(SceneDataset(str(tmp_path / "l.txt"), "chunk", cfg), cfg, 1))
    finally:
        native.load_library.cache_clear()
    assert not any(f.suffix == ".so" for f in (tmp_path / "build").iterdir())
