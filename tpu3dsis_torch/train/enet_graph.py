"""The training step's ENet over a batch's views, replayed from captured CUDA
graphs on the card (``build_loss_fn``'s color stage).

The ENet (``models/enet2d.py``) is about a thousand small launches forward
over a batch's views and about twice that backward, each a few
microseconds of card work, so the host's enqueue of them sets the pace.
Its input shape follows from the batch, and it syncs with the host
nowhere, draws no random numbers and updates no state in the forward; the
solver updates its parameters in place. So a graph captured once replays
it whole, reading the parameters where the capture found them: reload
weights in place (``load_state_dict``), not as new tensors.

``EnetFeatures(projector, dtype)(images)`` is ``projector.image_features``
on the batch's (V, H, W, C) images (the uint8 normalisation included),
cast to ``dtype`` where autograd does not record:

- on the CPU, or without an ENet, that call, eagerly;
- on a CUDA device, by key (the images' shape and dtype, the grad mode,
  the device): a key's first call runs eagerly (it warms cuDNN and the
  allocator), its second captures and then runs eagerly, and every later
  one replays. The capture comes first in its call, while no autograd
  graph holds the ENet's parameters: one that did (the call's own eager
  forward) would hand the backward's capture their gradient accumulators,
  made on the current stream, and the capture would fail. The last
  ``GRAPH_KEYS`` keys used are kept, so a trainer's partial last batch
  gets a key of its own.

Without a gradient (a frozen ENet, ``FIX_ENET: True``) a key holds one
forward graph, from its images buffer to the cast features. With one
(``FIX_ENET: False``) it holds a forward and a backward graph, in the
instance's one memory pool, replayed by an autograd Function as
``torch.cuda.make_graphed_callables`` replays them: the forward copies the
images in and replays, the backward copies the features' gradient in and
replays, and hands out the gradients of every ENet parameter that
requires one, as ``autograd.grad`` would. The graphs launch the kernels
eager mode launches, on the same operands, so the features and the
gradients equal eager mode's bit for bit.
"""

from __future__ import annotations

import torch

from tpu3dsis_torch.utils import tracing

GRAPH_KEYS = 4  # keys whose count of eager calls and captured graphs are kept, least recently used out


class _Replay(torch.autograd.Function):
    """A key's forward graph, and its backward graph as the backward.

    What it hands out are the graphs' static buffers: the features until
    the key's next forward replay, the parameters' gradients until its
    next backward replay; and the activations that the backward graph
    reads lie in the pool that every key's capture draws on. That is sound
    because the train step calls the ENet once and runs its backward
    before the next step's forward: the fusion's backward (K3b, which
    saved these features) and the update (which reads the gradients) come
    first. A caller that replayed the ENet again before the backward of
    the last call would have to copy what it got."""

    @staticmethod
    def forward(ctx, graph, images, *params):
        graph["images"].copy_(images)
        graph["forward"].replay()
        ctx.graph = graph
        return graph["features"].detach()  # a tensor of its own for autograd, on the static buffer

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        graph = ctx.graph
        graph["grad"].copy_(grad)
        graph["backward"].replay()
        return (None, None, *graph["grads"])


class EnetFeatures:
    """The ENet's features of a batch's views for the train step (the
    module's docstring): eager on the CPU, replayed from captured graphs on
    a CUDA device."""

    def __init__(self, projector, dtype: torch.dtype):
        self.proj = projector
        self.dtype = dtype
        self._keys = {}  # key -> {"eager": calls run eagerly, "graph": once captured}, least recent first
        self._stats = None  # the normalisation's mean and std on the card, made once
        self._pool = None  # the one memory pool of every key's graphs
        self._stream = None  # the side stream the captures run on

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        if not self._graphs(images):
            return self._cast(self.proj.image_features(images))
        if self._stats is None:
            self._stats = (self.proj.color_mean.to(images.device), self.proj.color_std.to(images.device))
        entry = self._entry((tuple(images.shape), images.dtype, torch.is_grad_enabled(), images.device))
        graph = entry.get("graph")
        if graph is None:
            entry["eager"] += 1
            if entry["eager"] > 1:
                with tracing.span("train.enet_capture"):
                    entry["graph"] = self._capture(images)
            return self._eager(images)
        with tracing.span("train.enet_replay"):
            if graph["params"] is None:
                graph["images"].copy_(images)
                graph["forward"].replay()
                return graph["features"]
            return _Replay.apply(graph, images, *graph["params"])

    def _graphs(self, images: torch.Tensor) -> bool:
        """Do these images take the graphs? On a CUDA device, with an ENet."""
        return images.device.type == "cuda" and self.proj.enet is not None

    def _cast(self, feats: torch.Tensor) -> torch.Tensor:
        return feats if torch.is_grad_enabled() else feats.to(self.dtype)

    def _eager(self, images: torch.Tensor) -> torch.Tensor:
        return self._cast(self.proj.image_features(images, stats=self._stats))

    def _entry(self, key) -> dict:
        entry = self._keys.pop(key, None)
        if entry is None:
            entry = {"eager": 0}
        self._keys[key] = entry  # the most recently used last
        while len(self._keys) > GRAPH_KEYS:
            self._keys.pop(next(iter(self._keys)))
        return entry

    def _capture(self, images: torch.Tensor) -> dict:
        """Capture a key's forward graph and, where autograd records and
        ENet parameters require a gradient, its backward graph: {forward,
        images, features, and backward, grad, grads, params (those that
        required a gradient at the capture), or params None}. The static buffers
        come from the ordinary allocator on the current stream; what the
        graphs allocate comes from the instance's pool, so memory grows
        with the largest key and not with the keys. Each capture is begun
        and ended by hand on a side stream, thread-local
        (``capture_error_mode``), as ``SceneInference._capture`` does
        (``infer/tiling.py``): ``torch.cuda.graph`` would wait for the whole
        card and empty the caching allocators. The backward's capture runs
        ``autograd.grad`` on the captured forward; its kernels are launched
        on the side stream, where the forward's ran."""
        dev = images.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        params = [p for p in self.proj.enet.parameters() if p.requires_grad] if torch.is_grad_enabled() else []
        graph = {"images": torch.empty_like(images), "forward": torch.cuda.CUDAGraph(), "params": params or None}
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            graph["forward"].capture_begin(self._pool, capture_error_mode="thread_local")
            try:
                feats = self._eager(graph["images"])
            finally:
                graph["forward"].capture_end()
        graph["features"] = feats.detach()
        if params:
            # contiguous, as the fusion's backward (K3b) hands the gradient over
            graph["grad"] = torch.empty(feats.shape, dtype=feats.dtype, device=dev)
            graph["backward"] = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._stream):
                graph["backward"].capture_begin(self._pool, capture_error_mode="thread_local")
                try:
                    graph["grads"] = torch.autograd.grad(feats, params, graph["grad"], allow_unused=True)
                finally:
                    graph["backward"].capture_end()
        current.wait_stream(self._stream)
        return graph
