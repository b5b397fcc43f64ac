"""The port's training targets, losses and box encodings against the JAX
package's, on the CPU. The targets' random subsampling takes the uniform
draws ``jax.random`` makes for the same keys, so the targets must agree
exactly (the log-size regression deltas to one float32 ulp), the
empty-background and empty-foreground branches included; the losses
within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsis.geometry import boxes as jboxes
from tpu3dsis.train import losses as JL
from tpu3dsis.train import targets as JT
from tpu3dsis_torch.geometry import boxes as tboxes
from tpu3dsis_torch.train import losses as TL
from tpu3dsis_torch.train import targets as TT


def jax_draws(key, n):
    """The two uniform draws of one ``_rank_select`` pair / ``ranked_indices``
    pair: split(key) -> uniform(k, (n,)) each."""
    return np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(key)])


def pad_gt(rng, n_valid, max_gt=6, extent=(32, 16, 32)):
    gt = np.zeros((max_gt, 7), np.float32)
    gt[:, :3] = -1e4
    gt[:, 3:6] = -1e4 + 1
    for j in range(n_valid):
        lo = rng.randint(0, np.asarray(extent) - 6)
        gt[j, :3] = lo
        gt[j, 3:6] = lo + rng.randint(3, 12, 3)
        gt[j, 6] = rng.choice([3, 5, 6, 7, 9, 12, 18])
    return gt, np.arange(max_gt) < n_valid


def near(rng, gt, n, jitter=3.0):
    """n boxes around the valid gt boxes, some far away."""
    base = gt[rng.randint(0, max(1, (gt[:, 0] > -1e3).sum()), n), :6]
    out = base + rng.uniform(-jitter, jitter, (n, 6))
    far = rng.rand(n) < 0.2
    out[far] = np.concatenate([np.full((far.sum(), 3), 200.0), np.full((far.sum(), 3), 210.0)], 1)
    out[:, 3:] = np.maximum(out[:, 3:], out[:, :3] + 0.5)
    return out.astype(np.float32)


def assert_same(got: dict, want: dict):
    """Equal, but for the regression targets, whose log-size deltas may be
    one float32 ulp apart (XLA's log and torch's); every other column, the
    labels, the selected rois and the validity are equal."""
    for k, w in want.items():
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        if k == "bbox_targets":
            np.testing.assert_array_max_ulp(g, np.asarray(w), maxulp=1)
            g6, w6 = g.reshape(*g.shape[:-1], -1, 6), np.asarray(w).reshape(*g.shape[:-1], -1, 6)
            np.testing.assert_array_equal(g6[..., :3], w6[..., :3], err_msg=k)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


@pytest.mark.parametrize("level3", [False, True])
def test_anchor_targets_match_jax(level3):
    rng = np.random.RandomState(0)
    levels = (1, 3) if level3 else (1, 2)
    gts = [pad_gt(rng, n) for n in (2, 4, 1)]
    anchors, inside = {}, {}
    for lvl in levels:
        a = near(rng, gts[0][0], 150, jitter=4.0) if lvl == 1 else near(rng, gts[1][0], 90, jitter=6.0)
        anchors[lvl] = a
        inside[lvl] = (a[:, :3] >= 0).all(1) & (a[:, 3:] <= [32, 16, 32]).all(1)
    n = sum(a.shape[0] for a in anchors.values())
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    draws = np.stack([jax_draws(k, n) for k in keys])
    got = TT.anchor_targets(torch.from_numpy(draws), {l: torch.from_numpy(a) for l, a in anchors.items()},
                            {l: torch.from_numpy(m) for l, m in inside.items()},
                            torch.from_numpy(np.stack([g for g, _ in gts])),
                            torch.from_numpy(np.stack([v for _, v in gts])), 16, 0.5, 0.35, 0.15)
    for b, (gt, valid) in enumerate(gts):
        want = JT.anchor_targets(keys[b], {l: jnp.asarray(a) for l, a in anchors.items()},
                                 {l: jnp.asarray(m) for l, m in inside.items()}, jnp.asarray(gt),
                                 jnp.asarray(valid), 16, 0.5, 0.35, 0.15)
        for lvl in levels:
            labels = np.asarray(want[lvl]["labels"])
            assert_same({k: v[b] for k, v in got[lvl].items()}, want[lvl])
        if b == 0:
            assert (labels == 1).sum() + (labels == 0).sum() > 0
    # the first sample has more candidates than RPN_BATCHSIZE: subsampling ran
    all1 = np.concatenate([got[l]["labels"][0].numpy() for l in levels])
    assert (all1 >= 0).sum() == 16 and (all1 == 1).sum() > 0


@pytest.mark.parametrize("case", ["mixed", "bg_empty", "fg_empty"])
def test_proposal_targets_match_jax(case):
    rng = np.random.RandomState(1)
    gts = [pad_gt(rng, n) for n in (3, 2)]
    rois, valid, levels = [], [], []
    for gt, _ in gts:
        if case == "bg_empty":  # every valid roi is a gt box: IoU 1
            r = gt[np.arange(12) % 2, :6]
        elif case == "fg_empty":  # no roi reaches FG_THRESH; no gt injected
            r = near(rng, gt, 12, jitter=6.0)
        else:
            r = near(rng, gt, 12)
        rois.append(r.astype(np.float32))
        valid.append(rng.rand(12) > 0.2)
        levels.append(rng.randint(1, 3, 12).astype(np.float32))
    use_gt = case != "fg_empty"
    n = 12 + (6 if use_gt else 0)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    draws = np.stack([jax_draws(k, n) for k in keys])
    args = (19, 8, 0.5, 0.5, 0.2, 0.0, use_gt)
    got = TT.proposal_targets(torch.from_numpy(draws), torch.from_numpy(np.stack(rois)),
                              torch.from_numpy(np.stack(valid)), torch.from_numpy(np.stack(levels)),
                              torch.from_numpy(np.stack([g for g, _ in gts])),
                              torch.from_numpy(np.stack([v for _, v in gts])), *args)
    fg_rows = []
    for b, (gt, gv) in enumerate(gts):
        want = JT.proposal_targets(keys[b], jnp.asarray(rois[b]), jnp.asarray(valid[b]), jnp.asarray(levels[b]),
                                   jnp.asarray(gt), jnp.asarray(gv), *args)
        assert_same({k: v[b] for k, v in got.items()}, want)
        fg_rows.append(int((np.asarray(want["labels"]) > 0).sum()))
    if case == "bg_empty":
        assert fg_rows == [8, 8]  # every row foreground
    elif case == "fg_empty":
        assert fg_rows == [0, 0]


def test_mask_targets_match_jax():
    rng = np.random.RandomState(2)
    gts = [pad_gt(rng, n) for n in (4, 1, 0)]
    rois = np.stack([near(rng, g, 10, jitter=1.0) for g, _ in gts])
    valid = rng.rand(3, 10) > 0.1
    got = TT.mask_targets(torch.from_numpy(rois), torch.from_numpy(valid),
                          torch.from_numpy(np.stack([g for g, _ in gts])),
                          torch.from_numpy(np.stack([v for _, v in gts])), 0.5, 5)
    counts = []
    for b, (gt, gv) in enumerate(gts):
        want = JT.mask_targets(jnp.asarray(rois[b]), jnp.asarray(valid[b]), jnp.asarray(gt), jnp.asarray(gv), 0.5, 5)
        assert_same({k: v[b] for k, v in got.items()}, want)
        counts.append(int(np.asarray(want["valid"]).sum()))
    assert counts[0] == 5 and counts[2] == 0  # capped, and empty


def test_level3_inflation_matches_jax():
    rng = np.random.RandomState(3)
    gt, _ = pad_gt(rng, 6)
    gt[2, 3:6] = gt[2, :3] + [4, 4, 4]  # a cube: the thinnest dim ties, the first wins
    np.testing.assert_array_equal(TT._inflate_gt_for_level3(torch.from_numpy(gt)).numpy(),
                                  np.asarray(JT._inflate_gt_for_level3(jnp.asarray(gt))))


def test_box_encoding_and_overlap_match_jax():
    rng = np.random.RandomState(4)
    a = near(rng, pad_gt(rng, 3)[0], 40)
    b = near(rng, pad_gt(rng, 3)[0], 30)
    np.testing.assert_array_equal(tboxes.bbox_overlap(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jboxes.bbox_overlap(jnp.asarray(a), jnp.asarray(b))))
    # log may round an ulp apart between XLA and torch
    np.testing.assert_allclose(tboxes.bbox_transform(torch.from_numpy(a), torch.from_numpy(a[::-1].copy())).numpy(),
                               np.asarray(jboxes.bbox_transform(jnp.asarray(a), jnp.asarray(a[::-1].copy()))),
                               rtol=1e-6, atol=1e-6)


def test_rpn_and_class_losses_match_jax():
    rng = np.random.RandomState(5)
    b, w, h, l, a = 2, 4, 2, 4, 3
    n = w * h * l * a
    cls_score = rng.randn(b, w, h, l, 2, a).astype(np.float32)
    bbox_pred = rng.randn(b, w, h, l, 6 * a).astype(np.float32)
    tgt = {"labels": rng.randint(-1, 2, (b, n)).astype(np.int32),
           "bbox_targets": rng.randn(b, n, 6).astype(np.float32),
           "inside_w": (rng.rand(b, n, 6) > 0.5).astype(np.float32),
           "outside_w": (rng.rand(b, n, 6) * 0.1).astype(np.float32)}
    ce, box = TL.rpn_level_losses(torch.from_numpy(cls_score), torch.from_numpy(bbox_pred),
                                  {k: torch.from_numpy(v) for k, v in tgt.items()})
    for i in range(b):
        jce, jbox = JL.rpn_level_losses(jnp.asarray(cls_score[i:i + 1]), jnp.asarray(bbox_pred[i:i + 1]),
                                        {k: jnp.asarray(v[i]) for k, v in tgt.items()})
        np.testing.assert_allclose([float(ce[i]), float(box[i])], [float(jce), float(jbox)], rtol=1e-6)

    s, c = 8, 19
    cls = rng.randn(b, s, c).astype(np.float32)
    bbox = rng.randn(b, s, 6 * c).astype(np.float32)
    pt = {"labels": rng.randint(0, c, (b, s)).astype(np.int32), "bbox_targets": rng.randn(b, s, 6 * c).astype(np.float32),
          "inside_w": (rng.rand(b, s, 6 * c) > 0.9).astype(np.float32)}
    pt["outside_w"] = pt["inside_w"].copy()
    weights = np.concatenate([[0.3], rng.uniform(0.5, 1.5, c - 1)]).astype(np.float32)
    ce, box = TL.class_losses(torch.from_numpy(cls), torch.from_numpy(bbox), {k: torch.from_numpy(v) for k, v in pt.items()},
                              torch.from_numpy(weights))
    for i in range(b):
        jce, jbox = JL.class_losses(jnp.asarray(cls[i]), jnp.asarray(bbox[i]), {k: jnp.asarray(v[i]) for k, v in pt.items()},
                                    jnp.asarray(weights))
        np.testing.assert_allclose([float(ce[i]), float(box[i])], [float(jce), float(jbox)], rtol=1e-6)


def test_mask_losses_match_jax():
    """One queue and two queues of other canvases sharing one roi space;
    the batched form (labels (B, M), roi_idx into B*M rois) per sample."""
    rng = np.random.RandomState(6)
    m, nc = 4, 5

    def group(c, canvas):
        return (rng.randn(c, *canvas, nc).astype(np.float32), (rng.rand(c, *canvas) > 0.5).astype(np.float32),
                (rng.rand(c, *canvas) > 0.3).astype(np.float32), rng.rand(c) > 0.2,
                rng.randint(0, m, c).astype(np.int32))

    labels = rng.randint(0, nc, (2, m)).astype(np.int32)
    labels[:, 0] = 2  # a foreground roi in each sample
    valid = rng.rand(2, m) > 0.2
    valid[:, 0] = True
    weights = rng.uniform(0.5, 1.5, nc).astype(np.float32)
    g1, g2 = group(3, (4, 3, 4)), group(2, (6, 2, 5))
    want_one = float(JL.mask_loss_windowed(*map(jnp.asarray, g1), jnp.asarray(labels[0]), jnp.asarray(valid[0]),
                                           jnp.asarray(weights), m))
    got_one = float(TL.mask_loss_windowed(*map(torch.from_numpy, g1), torch.from_numpy(labels[0]),
                                          torch.from_numpy(valid[0]), torch.from_numpy(weights), m))
    np.testing.assert_allclose(got_one, want_one, rtol=1e-6)
    want = [float(JL.mask_loss_window_groups([tuple(map(jnp.asarray, g)) for g in (g1, g2)], jnp.asarray(labels[i]),
                                             jnp.asarray(valid[i]), jnp.asarray(weights), m)) for i in range(2)]
    # the batched form: sample 1 holds the same queues, its rois offset by m
    both = [tuple(torch.from_numpy(np.concatenate([x, x])) for x in g[:4])
            + (torch.from_numpy(np.concatenate([g[4], g[4] + m])),) for g in (g1, g2)]
    got = TL.mask_loss_window_groups(both, torch.from_numpy(labels), torch.from_numpy(valid), torch.from_numpy(weights), m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    roi = np.array([1.4, 0.5, 2.6, 5.5, 2.5, 4.4], np.float32)
    np.testing.assert_array_equal(TL.roi_region_mask(torch.from_numpy(roi), (6, 3, 5)).numpy(),
                                  np.asarray(JL.roi_region_mask(jnp.asarray(roi), (6, 3, 5))))
