"""3D-SIS's training step in plain PyTorch: the benchmark's reference for
training cells (3D-SIS's ``lib/model/trainval.py`` and ``network.py``'s
TRAIN branch, with its ``anchor_target_layer``, ``proposal_layer``,
``proposal_target_layer`` and ``mask_target_layer``).

Float32 throughout, one sample at a time after the batch's backbone. The
random subsampling of the targets ranks the members of a set by uniform
draws that the caller passes (the same draws the program is given):
``draws["anchor"]`` (B, 2, anchors of all levels: foreground, then
background) and ``draws["proposal"]`` (B, 2, post-NMS slots + gt slots).
Departures from the published layers, each the program's too: no
"best anchor of each gt" foreground rule; a foreground or background pool
smaller than its quota is cycled; the mask FCN is trained on each mask
roi's exact crop (the program's halo windows compute the same).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import geometry as G
from portbench.reference import nets as N


def frozen(name: str, cfg: dict) -> bool:
    """3D-SIS's ``fix_eval_parts`` by name (``trainval.py``)."""
    if cfg["FIX_BACKBONE"] and ("geometry" in name or "color" in name or "combine" in name) \
            and "mask_backbone" not in name:
        return True
    if cfg["FIX_RPN"] and "rpn" in name:
        return True
    if cfg["FIX_CLASS"] and "classifier" in name:
        return True
    return bool(cfg["FIX_ENET"] and "enet" in name)


def _rank_members(draws, member, quota):
    """The members with the ``quota`` largest draws (ties by index)."""
    scores = torch.where(member, draws, torch.full_like(draws, -1.0))
    order = torch.argsort(-scores, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return member & (rank < quota)


def _ranked(draws, member):
    scores = torch.where(member, draws, torch.full_like(draws, -1.0))
    return torch.argsort(-scores, stable=True)


def _overlaps(boxes, gt, gt_valid):
    ov = G.iou(boxes, gt[:, :6])
    ov = torch.where(gt_valid[None, :], ov, torch.full_like(ov, -1.0))
    return ov.amax(1), ov.argmax(1)


def smooth_l1(pred, target, inside_w, outside_w, sigma):
    s2 = sigma * sigma
    d = inside_w * (pred - target)
    a = d.abs()
    small = (a < 1.0 / s2).float()
    return outside_w * (small * 0.5 * s2 * d * d + (1 - small) * (a - 0.5 / s2))


class TrainReference:
    def __init__(self, model: dict, cfg: dict, prec: N.Precision = N.FP32):
        self.model, self.cfg, self.prec = model, cfg, prec
        self.shape = tuple(cfg["TPU_TILE_SIZE"])
        self.anchors = {}
        for lvl in (1, 2):
            a, inside = G.level_anchors(model[f"ANCHORS_TYPE_LEVEL{lvl}"], self.shape)
            self.anchors[lvl] = (torch.from_numpy(a), torch.from_numpy(inside))

    def sample_loss(self, p, b, maps, rpn, gt, gt_valid, canvas, scene, draws_a, draws_p):
        """One sample's losses {name: 0-d}."""
        cfg, dev = self.cfg, gt.device
        anchors = {lvl: (a.to(dev), ins.to(dev)) for lvl, (a, ins) in self.anchors.items()}
        losses = {}
        # --- anchor targets and the RPN's losses
        if not cfg["FIX_RPN"]:
            labels, argmax = {}, {}
            for lvl in (1, 2):
                a, inside = anchors[lvl]
                ov, arg = _overlaps(a, gt, gt_valid)
                lab = torch.full_like(arg, -1)
                lab = torch.where(ov >= cfg["RPN_POSITIVE_OVERLAP"], 1, lab)
                lab = torch.where(ov < cfg["RPN_NEGATIVE_OVERLAP"], 0, lab)
                labels[lvl], argmax[lvl] = torch.where(inside, lab, -1), arg
            all_l = torch.cat([labels[1], labels[2]])
            fg = all_l == 1
            keep = _rank_members(draws_a[0], fg, int(cfg["RPN_FG_FRACTION"] * cfg["RPN_BATCHSIZE"]))
            all_l = torch.where(fg & ~keep, -1, all_l)
            bg = all_l == 0
            keep = _rank_members(draws_a[1], bg, cfg["RPN_BATCHSIZE"] - int((all_l == 1).sum()))
            all_l = torch.where(bg & ~keep, -1, all_l)
            off = 0
            for lvl in (1, 2):
                a, inside = anchors[lvl]
                n = a.shape[0]
                lab = all_l[off:off + n]
                off += n
                cls, box = rpn[lvl]
                logits = cls[b].float().movedim(3, 4).reshape(n, 2)
                sel = lab != -1
                ce = F.cross_entropy(logits, lab.clamp(min=0), reduction="none")
                losses[f"rpn_ce{lvl}"] = torch.where(sel, ce, 0.0).sum() / sel.sum().clamp(min=1)
                tgt = torch.where(inside[:, None], G.bbox_transform(a, gt[argmax[lvl], :6]), 0.0)
                pos = (lab == 1).float()[:, None]
                w_out = pos / pos.sum().clamp(min=1)
                losses[f"rpn_box{lvl}"] = smooth_l1(box[b].float(), tgt, pos, w_out, 2.0).sum()
        # --- proposals: the top by objectness, greedy NMS, the first kept (no gradient)
        with torch.no_grad():
            props, scores, levels, valid = [], [], [], []
            for lvl in (1, 2):
                a, inside = anchors[lvl]
                cls, box = rpn[lvl]
                prob = torch.softmax(cls[b].float(), dim=3)[:, :, :, 1, :].reshape(-1)
                props.append(G.clip_boxes(G.bbox_transform_inv(a, box[b].float()), self.shape))
                scores.append(prob)
                levels.append(torch.full_like(prob, lvl))
                valid.append(inside)
            props, scores, levels, valid = (torch.cat(t) for t in (props, scores, levels, valid))
            masked = torch.where(valid, scores, torch.full_like(scores, -1e9))
            top = torch.sort(masked, descending=True, stable=True)[1][:int(cfg["TRAIN"]["RPN_PRE_NMS_TOP_N"])]
            top = top[valid[top]]
            keep = np.nonzero(G.greedy_nms(props[top], float(cfg["TRAIN"]["RPN_NMS_THRESH"])))[0]
            post = int(cfg["TRAIN"]["RPN_POST_NMS_TOP_N"])
            kept = top[torch.from_numpy(keep[:post]).to(dev)]
            rois = torch.zeros((post, 6), device=dev)
            rlev = torch.ones(post, device=dev)
            rvalid = torch.zeros(post, dtype=torch.bool, device=dev)
            rois[:len(kept)], rlev[:len(kept)], rvalid[:len(kept)] = props[kept], levels[kept], True
        # --- proposal targets and the classifier's losses
        if not cfg["FIX_CLASS"]:
            dims = gt[:, 3:6] - gt[:, :3]
            gt_lev = torch.where((dims <= 20.0).all(1), 1.0, 2.0)
            cand = torch.cat([rois, gt[:, :6]]) if cfg["USE_GT"] else rois
            clev = torch.cat([rlev, gt_lev]) if cfg["USE_GT"] else rlev
            cval = torch.cat([rvalid, gt_valid]) if cfg["USE_GT"] else rvalid
            ov, assign = _overlaps(cand, gt, gt_valid)
            fg = cval & (ov >= cfg["FG_THRESH"])
            bg = cval & (ov < cfg["BG_THRESH"]) & (ov >= cfg["BG_THRESH_LO"])
            nfg, nbg = int(fg.sum()), int(bg.sum())
            size = int(cfg["CLASS_BATCH_SIZE"])
            quota = int(round(cfg["FG_FRACTION"] * size))
            num_fg = min(nfg, quota) if nbg > 0 else (size if nfg > 0 else 0)
            fg_r, bg_r = _ranked(draws_p[0], fg), _ranked(draws_p[1], bg)
            rows = torch.arange(size, device=dev)
            idx = torch.where(rows < num_fg, fg_r[rows % max(nfg, 1)], bg_r[(rows - num_fg) % max(nbg, 1)])
            labels = torch.where(rows < num_fg, gt[assign[idx], 6], 0.0).long()
            sel_rois, sel_lev = cand[idx], clev[idx].long()
            pool5 = G.roi_pool({1: maps[1][b], 2: maps[2][b]}, sel_rois, sel_lev, int(self.model["CLASS_POOLING_SIZE"]))
            score, deltas = N.classifier(p, pool5, self.prec)
            w = torch.tensor(cfg["NORMALIZE_WEIGHTS"], device=dev)[labels]
            ce = F.cross_entropy(score.float(), labels, reduction="none")
            losses["class_ce"] = (w * ce).sum() / w.sum().clamp(min=1e-12)
            nc = int(self.model["NUM_CLASSES"])
            t6 = G.bbox_transform(sel_rois, gt[assign[idx], :6])
            onehot = F.one_hot(labels, nc).float()
            tgt = (onehot[:, :, None] * t6[:, None, :]).reshape(size, -1)
            w_in = (onehot * (labels > 0)[:, None])[:, :, None].expand(size, nc, 6).reshape(size, -1)
            losses["class_box"] = smooth_l1(deltas.float(), tgt, w_in, (w_in > 0).float(), 1.0).sum(1).mean()
        # --- mask targets and the mask FCN's loss
        if cfg["USE_MASK"]:
            cand = torch.cat([rois, gt[:, :6]])
            cval = torch.cat([rvalid, gt_valid])
            ov, assign = _overlaps(cand, gt, gt_valid)
            fg = torch.nonzero(cval & (ov >= cfg["MASK_FG_THRESH"]))[:, 0][:int(cfg["TPU_MAX_MASK_ROIS"])]
            weights = torch.tensor(cfg["NORMALIZE_WEIGHTS"], device=dev)
            weights[0] = 0.0
            total, count = torch.zeros((), device=dev), 0
            for i in fg.tolist():
                r = torch.round(cand[i]).long().tolist()
                lo = [min(max(r[d], 0), self.shape[d] - 1) for d in range(3)]
                hi = [min(max(r[3 + d], lo[d] + 1), self.shape[d]) for d in range(3)]
                crop = scene[b][:, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
                label = int(gt[assign[i], 6])
                logit = N.mask_fcn(p, crop[None], self.prec)[0, label].float()
                t = canvas[b][lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].float()
                bce = (logit.clamp(min=0) - logit * t + torch.log1p(torch.exp(-logit.abs()))).mean()
                wl = weights[label]
                total = total + bce * wl
                count += int(wl != 0)
            losses["mask"] = total / count if count else total
        return losses

    def loss(self, p: dict, batch: dict, draws: dict):
        """The batch's total loss (the mean of the samples' sums) and each
        sample's losses."""
        cfg, model = self.cfg, self.model
        dev = p["geometry2.0.weight"].device
        data = torch.as_tensor(batch["data"]).to(dev, torch.float32)
        scene = data.permute(0, 4, 1, 2, 3).contiguous()
        imageft = None
        if model["USE_IMAGES"]:
            with torch.set_grad_enabled(not cfg["FIX_ENET"]):
                images = torch.as_tensor(batch["images"]).to(dev)
                bsz, v = images.shape[:2]
                x = N.normalise_images(images.reshape(-1, *images.shape[2:]), cfg["COLOR_MEAN"], cfg["COLOR_STD"])
                feats = N.enet_features(p, x, self.prec).reshape(bsz, v, *self.enet_hw(), -1)
                vols = [G.fuse_views(feats[i], torch.as_tensor(batch["depths"][i]).to(dev), batch["poses"][i],
                                     batch["world_to_grid"][i], cfg["INTRINSIC"], self.shape, cfg["PROJ_DEPTH_MIN"],
                                     cfg["PROJ_DEPTH_MAX"], cfg["VOXEL_SIZE"]) for i in range(bsz)]
                imageft = torch.stack(vols).permute(0, 4, 1, 2, 3).contiguous()
        lvl1, lvl2 = N.backbone(p, model["NET"], model["USE_IMAGES"], scene, imageft, self.prec)
        maps = {1: lvl1, 2: lvl2}
        rpn = {lvl: N.rpn_level(p, lvl, maps[lvl], int(model[f"NUM_ANCHORS_LEVEL{lvl}"]), self.prec)
               for lvl in (1, 2)}
        gt_all = torch.as_tensor(batch["gt_box"]).to(dev, torch.float32)
        gv_all = torch.as_tensor(batch["gt_valid"]).to(dev, torch.bool)
        canvas = torch.as_tensor(batch["mask_canvas"]).to(dev)
        da, dp = (torch.as_tensor(draws[k]).to(dev, torch.float32) for k in ("anchor", "proposal"))
        per = [self.sample_loss(p, b, maps, rpn, gt_all[b], gv_all[b], canvas, scene, da[b], dp[b])
               for b in range(data.shape[0])]
        totals = [sum(s.values()) for s in per]
        return torch.stack(totals).mean(), per

    def enet_hw(self):
        w, h = self.cfg["DEPTH_SHAPE"]
        return h, w

    def steps(self, params: dict, batches: list, draws: list) -> dict:
        """SGD with momentum from ``params`` over the batches, as
        ``trainval.py`` sets it up (weight decay on weights only unless
        BIAS_DECAY, biases at twice the rate with DOUBLE_BIAS). Returns
        {"losses": [each step's total], "grad": {leaf: the first step's
        gradient as the optimizer took it, weight decay added}, "change":
        {leaf: its change over the steps}}."""
        cfg = self.cfg
        p = {k: v.detach().clone() for k, v in params.items()}
        train = sorted(k for k in p if not frozen(k, cfg))
        for k in train:
            p[k].requires_grad_(True)
        mom = {k: torch.zeros_like(p[k]) for k in train}
        lr = float(np.float32(cfg["LEARNING_RATE"]))
        out = {"losses": [], "grad": {}, "change": {}}
        for s, (batch, dr) in enumerate(zip(batches, draws)):
            total, _ = self.loss(p, batch, dr)
            grads = torch.autograd.grad(total, [p[k] for k in train], allow_unused=True)
            out["losses"].append(float(total.detach()))
            with torch.no_grad():
                for k, g in zip(train, grads):
                    g = torch.zeros_like(p[k]) if g is None else g
                    bias = "bias" in k
                    if not bias or cfg["BIAS_DECAY"]:
                        g = g + cfg["WEIGHT_DECAY"] * p[k]
                    mom[k] = cfg["MOMENTUM"] * mom[k] + g
                    if s == 0:
                        out["grad"][k] = mom[k].clone()
                    p[k] -= lr * (2.0 if bias and cfg["DOUBLE_BIAS"] else 1.0) * mom[k]
        out["change"] = {k: (p[k] - params[k]).detach() for k in train}
        return out
