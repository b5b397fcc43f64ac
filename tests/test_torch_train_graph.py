"""The train step's ENet replayed from captured CUDA graphs
(``tpu3dsis_torch/train/enet_graph.py``).

On the CPU, where the step never captures, the capture is stood in for by
one whose "graphs" run the eager ENet on the static buffers: a key's
first call runs eagerly, its second captures and then runs eagerly, its
later ones replay, and the replays hand out what eager calls give, features and
the ENet's gradients alike, bit for bit; keys by shape and grad mode, the
LRU's bound; SUNCG's step with the ENet trained, stood in for, equals its
eager step. On the card (``-m gpu``): the benchmark's two training cells,
graphed steps against eager ones, bit for bit, and a step's one host
sync.

No JAX: the card's test runs under ``--noconftest``.
"""

import os
import traceback
import warnings

import pytest
import torch

from test_torch_train_enet_bench import BATCH, SEED, STEPS, THREADS, make_batch, program_steps, small_config
from tpu3dsis_torch.config import DetectorConfig, default_config
from tpu3dsis_torch.models.color import ColorProjector
from tpu3dsis_torch.models.enet2d import ENet2D
from tpu3dsis_torch.train import enet_graph, trainstep
from tpu3dsis_torch.train.enet_graph import EnetFeatures
from tpu3dsis_torch.utils import tracing

GRAPH_SPANS = {"train.enet_replay", "train.enet_capture"}


class _Graph:
    """A stood-in graph: ``replay`` runs ``fn`` and counts."""

    def __init__(self, fn):
        self.fn, self.replays = fn, 0

    def replay(self):
        self.replays += 1
        self.fn()


def stand_in_capture(self, images):
    """``EnetFeatures._capture`` on the CPU: static buffers as the real one
    keeps them, and "graphs" that run the eager ENet on them: the forward
    into the features buffer, the backward from the gradient buffer into
    the gradients' buffers (``autograd.grad`` on that forward)."""
    grad = torch.is_grad_enabled()
    params = [p for p in self.proj.enet.parameters() if p.requires_grad] if grad else []
    graph = {"images": torch.empty_like(images), "params": params or None}
    out = self._eager(images)
    graph["features"] = torch.empty_like(out).detach()
    last = {}

    def forward():
        with torch.set_grad_enabled(grad):
            last["out"] = self._eager(graph["images"])
        graph["features"].copy_(last["out"].detach())

    graph["forward"] = _Graph(forward)
    if params:
        graph["grad"] = torch.empty(out.shape, dtype=out.dtype)
        shapes = torch.autograd.grad(out, params, torch.zeros_like(out), allow_unused=True)
        graph["grads"] = tuple(None if g is None else torch.empty_like(g) for g in shapes)

        def backward():
            got = torch.autograd.grad(last.pop("out"), params, graph["grad"], allow_unused=True)
            for buf, g in zip(graph["grads"], got):
                if buf is not None:
                    buf.copy_(g)

        graph["backward"] = _Graph(backward)
    return graph


@pytest.fixture
def stood_in(monkeypatch):
    """EnetFeatures takes graphs on the CPU, captured by the stand-in."""
    monkeypatch.setattr(EnetFeatures, "_graphs", lambda self, images: True)
    monkeypatch.setattr(EnetFeatures, "_capture", stand_in_capture)


@pytest.fixture(scope="module")
def projector():
    """A seeded ENet behind the detector's projector, its parameters
    trainable as ``opt_init`` leaves them."""
    torch.manual_seed(3)
    enet = ENet2D(20)
    for p in enet.parameters():
        p.requires_grad_(True)
    return ColorProjector(DetectorConfig.from_cfg(default_config()), enet)


def _images(views=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (views, 32, 40, 3), generator=g, dtype=torch.uint8)


def _calls(feats, images, n, grad):
    """n calls, each with its spans under a ``train.enet`` of its own:
    [(features, the names of the spans it recorded)]."""
    out = []
    tracing.clear()
    with tracing.recording(), torch.set_grad_enabled(grad):
        for _ in range(n):
            with tracing.span("train.enet") as sp:
                f = feats(images)
            out.append((f, [s.name for s in tracing.spans() if s.parent is sp]))
    tracing.clear()
    return out


def test_on_the_cpu_nothing_is_captured(projector):
    """The CPU path is the eager call: no key, no graph span, the
    features those of ``image_features`` (cast where no gradient flows)."""
    feats, images = EnetFeatures(projector, torch.bfloat16), _images()
    for grad in (False, True):
        calls = _calls(feats, images, 3, grad)
        with torch.set_grad_enabled(grad):
            want = projector.image_features(images)
        want = want if grad else want.to(torch.bfloat16)
        assert all(names == [] and torch.equal(f, want) for f, names in calls)
    assert feats._keys == {} and feats._pool is None


@pytest.mark.parametrize("grad", [False, True], ids=["frozen", "trained"])
def test_a_key_captures_on_its_second_call(projector, stood_in, grad):
    """First call eager, second a capture and then eager, later ones
    replays: the same features as the eager calls, bit for bit, and with a
    gradient the same gradient of every ENet parameter."""
    feats, images = EnetFeatures(projector, torch.bfloat16), _images()
    calls = _calls(feats, images, 4, grad)
    assert [names for _, names in calls] == [[], ["train.enet_capture"], ["train.enet_replay"], ["train.enet_replay"]]
    (entry,) = feats._keys.values()
    assert entry["eager"] == 2 and entry["graph"]["forward"].replays == 2
    eager = calls[0][0]
    assert eager.dtype == (torch.float32 if grad else torch.bfloat16)
    for f, _ in calls:
        assert torch.equal(f, eager) and f.requires_grad == grad
    if grad:
        params = [p for p in projector.enet.parameters()]
        weights = torch.linspace(-1, 1, eager.numel()).reshape(eager.shape)
        want = torch.autograd.grad((eager * weights).sum(), params, allow_unused=True)
        got = torch.autograd.grad((calls[3][0] * weights).sum(), params, allow_unused=True)
        assert entry["graph"]["backward"].replays == 1
        assert sum(g is not None for g in want) > 400  # every leaf of features_for_3d, its statistics among them
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want))


def test_keys_by_shape_and_grad_mode_and_the_lru_bound(projector, stood_in):
    """Another batch shape is a key of its own, as is the other grad mode
    on the same images; the last ``GRAPH_KEYS`` keys used are kept."""
    feats = EnetFeatures(projector, torch.bfloat16)
    a, b = _images(2), _images(3)
    for images in (a, b):
        _calls(feats, images, 2, False)
    _calls(feats, a, 2, True)
    keys = list(feats._keys)
    assert [(k[0][0], k[2]) for k in keys] == [(2, False), (3, False), (2, True)]
    assert all("graph" in e for e in feats._keys.values())
    frozen, trained = feats._keys[keys[0]]["graph"], feats._keys[keys[2]]["graph"]
    assert frozen["params"] is None and "backward" not in frozen and frozen["features"].dtype == torch.bfloat16
    assert trained["params"] and trained["features"].dtype == torch.float32
    assert [names for _, names in _calls(feats, a, 1, False)] == [["train.enet_replay"]]
    assert list(feats._keys)[-1] == keys[0]
    for v in range(4, 4 + enet_graph.GRAPH_KEYS):
        _calls(feats, _images(v), 1, False)
    assert len(feats._keys) == enet_graph.GRAPH_KEYS and keys[0] not in feats._keys
    assert [k[0][0] for k in feats._keys] == list(range(4, 4 + enet_graph.GRAPH_KEYS))


def test_a_stood_in_step_trains_as_the_eager_step(stood_in):
    """SUNCG's step with the ENet trained (the enet bench's small case),
    its ENet stood in for from the second step's capture on, against the
    eager step: losses, the first step's gradient and the change of every
    parameter bit for bit; ``train.enet_capture`` in step 2,
    ``train.enet_replay`` in step 3, and ``train.enet_bwd`` in each."""
    from portbench import weights

    cfg = small_config()
    params = weights.make(cfg["model"], {"file": ""}, SEED, "cpu")
    g = torch.Generator().manual_seed(5)
    anchors = (32 // 4) * (16 // 4) * (32 // 4) * (3 + 6)
    draws = [{"anchor": torch.rand((BATCH, 2, anchors), generator=g), "proposal": torch.rand((BATCH, 2, 12), generator=g)}
             for _ in range(STEPS)]
    batches = [make_batch(i) for i in range(STEPS)]
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        tracing.clear()
        with tracing.recording():
            got, _ = program_steps(cfg, params, batches, draws)
        recorded = tracing.spans()
        tracing.clear()
        with pytest.MonkeyPatch.context() as m:
            m.setattr(EnetFeatures, "_graphs", lambda self, images: False)
            want, _ = program_steps(cfg, params, batches, draws)
    finally:
        torch.set_num_threads(threads)
    assert got["losses"] == want["losses"] and got["rpn_losses"] == want["rpn_losses"]
    for part in ("grad", "change"):
        assert got[part].keys() == want[part].keys()
        assert all(torch.equal(got[part][k], want[part][k]) for k in want[part]), part
    enet = [s for s in recorded if s.name == "train.enet"]
    assert [[c.name for c in recorded if c.parent is s] for s in enet] == [[], ["train.enet_capture"],
                                                                          ["train.enet_replay"]]
    assert sum(s.name == "train.enet_bwd" for s in recorded) == STEPS


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["suncg.train", "suncg.train-enet"])
def test_graphed_steps_equal_eager_steps_on_the_card(workload, monkeypatch):
    """On the card, the cell's configuration, weights and batches
    (``portbench``), 9 steps graphed against 9 eager ones: the set-up's 3
    (eager, a capture and eager, a replay), a replay, a partial batch of 5
    chunks three times (its own key: eager, capture, replay), then the
    weights reloaded in place and 2 replays. Every step's metrics
    (``step_finite`` among them) and every gradient, and the parameters
    and momentum at the end, bit for bit; with the recorder on, the graph
    spans where they belong and, where the ENet trains, its backward's span
    in every step.

    Both sides take cuDNN's deterministic algorithms, and where the ENet
    trains the eager side takes the graphed side's K3b gradients (the
    fusion's backward, ``fuse_views_backward_cuda``): its float32 atomics
    land in another order from one run to the next, so that two eager runs
    differ in a few of the ENet's gradients, and the graphs do not touch
    it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import harness, traffic
    from portbench.kinds.train_step import TrainStep
    from tpu3dsis_torch.geometry import projection

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    w = harness.cell(harness.benchmark(), workload)
    cfg, mix = harness.config(w["config"]), traffic.load(w["traffic"])
    trained = cfg["train"]["FIX_ENET"] is False
    partial = int(mix["batch"]) - 3
    k3b, k3b_grads = projection.fuse_views_backward_cuda, []

    def run(graphs: bool):
        updates, calls = [], iter(range(len(k3b_grads)))
        real = trainstep.apply_step_update

        def update(opt, grads, metrics):
            out = real(opt, grads, metrics)
            updates.append(({k: None if v is None else v.clone() for k, v in grads.items()},
                            {k: v.clone() for k, v in out.items()}))
            return out

        def fusion_backward(*args, **kw):
            out = k3b(*args, **kw)
            if graphs:
                k3b_grads.append(out.clone())
                return out
            return k3b_grads[next(calls)].clone()

        fusion_backward.launches = 0  # the wrapper counts its calls under the name it replaces
        with monkeypatch.context() as m:
            m.setattr(trainstep, "apply_step_update", update)
            m.setattr(projection, "fuse_views_backward_cuda", fusion_backward)
            if not graphs:
                m.setattr(EnetFeatures, "_graphs", lambda self, images: False)
            kind = TrainStep(cfg, mix, 3810000229)
            tracing.clear()
            with tracing.recording():
                kind.setup()

                def step(s, n=None):
                    idx = kind.order[s][:n]
                    draws = {k: v[:n] for k, v in kind.make_draws().items()}
                    kind.step(kind.opt, kind.make_batch(idx), draws=draws)

                step(3)
                for s in range(4, 7):
                    step(s, partial)
                state = kind.det.state_dict()
                kind.det.load_state_dict({k: v * 1.25 if k == "enet.0.0.weight" else v for k, v in state.items()},
                                         strict=True)
                step(7)
                step(8)
                torch.cuda.synchronize()
            recorded = tracing.spans()
            tracing.clear()
        end = {k: v.detach().clone() for k, v in kind.opt.params.items()}
        momentum = {k: v.clone() for k, v in kind.opt.momentum.items()}
        return updates, end, momentum, recorded

    graphed, eager = run(True), run(False)
    assert len(k3b_grads) == (9 if trained else 0)
    assert len(graphed[0]) == len(eager[0]) == 9
    for s, ((gg, gm), (eg, em)) in enumerate(zip(graphed[0], eager[0])):
        assert gm.keys() == em.keys() and all(torch.equal(gm[k], em[k]) for k in em), f"step {s + 1}: metrics"
        assert float(gm["step_finite"]) == 1.0
        differ = [k for k in eg if (gg[k] is None) != (eg[k] is None) or (eg[k] is not None
                                                                            and not torch.equal(gg[k], eg[k]))]
        assert not differ, f"step {s + 1}: gradients {differ[:8]} of {len(differ)}"
    for part, label in ((1, "parameters"), (2, "momentum")):
        differ = [k for k in eager[part] if not torch.equal(graphed[part][k], eager[part][k])]
        assert not differ, f"{label} {differ[:8]} of {len(differ)}"
    names = [sp.name for sp in graphed[3]]
    assert names.count("train.enet_capture") == 2 and names.count("train.enet_replay") == 5
    assert not GRAPH_SPANS & {sp.name for sp in eager[3]}
    assert names.count("train.enet_bwd") == (9 if trained else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["suncg.train", "suncg.train-enet"])
def test_a_step_syncs_the_host_once_on_the_card(workload):
    """On the card, the cell's steps after the set-up wait for the card in
    one place, the mask queue's ``nonzero`` (``torch.cuda``'s sync debug
    mode): no blocking upload of a constant (the anchor targets' quota, the
    mask loss's class weights), which would leave the host waiting on the
    replayed ENet's work."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import harness, traffic
    from portbench.kinds.train_step import TrainStep

    w = harness.cell(harness.benchmark(), workload)
    kind = TrainStep(harness.config(w["config"]), traffic.load(w["traffic"]), 3810000233)
    kind.setup()
    syncs = []

    def show(message, *args, **kw):
        if "synchronizing CUDA operation" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1] if "tpu3dsis_torch" in f.filename]
            syncs.append(f"{os.path.basename(ours[-1].filename)}:{ours[-1].name}" if ours else "elsewhere")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for s in range(3, 6):
                kind.step(kind.opt, kind.make_batch(kind.order[s]), draws=kind.make_draws())
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert syncs == ["trainstep.py:_mask_forward_scan"] * 3
