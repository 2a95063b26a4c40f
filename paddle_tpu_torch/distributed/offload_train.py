"""Host-offloaded, gradient-accumulating train step — the port of
paddle_tpu/distributed/offload_train.py (one card).

`OffloadTrainStep(model, loss_fn, optimizer, accumulate_steps=K)`: each
call is one micro-step (forward, backward, and the gradients added in
f32 to accumulators on the device, then dropped); every K-th call also
applies the optimizer with the mean gradient `acc / K`, chunk by chunk,
and zeroes the accumulators. The loss of a micro-step is the mean over
its micro-batch, so K micro-steps over the parts of a batch give the
update of one full-batch `jit.TrainStep`. As in the reference, no
`grad_clip` is applied here.

`param_dtype` casts the model's parameters on the device (e.g.
"bfloat16"); with a `multi_precision` optimizer each then has an f32
master in its state, so the update's precision is unaffected.

On a CUDA device the optimizer's states (moments, velocities, masters)
live in pinned host memory, one flat page-locked buffer per dtype
(`pinned_bytes`). The update streams them through the card one chunk at
a time (`_chunks`: consecutive parameters whose parameter, accumulator
and state bytes stay under `chunk_bytes`, so each transformer block is a
chunk of its own): the chunk's states are copied to the card on a
host-to-device stream, updated by the optimizer's `_foreach` rule on the
current stream, and copied back on a device-to-host stream. Chunk i+1's
copy in is issued before chunk i's update, so it overlaps it, and the
copies back run beside both (the two directions of the link at once):
events order each chunk's copy in, update and copy back, the staging
tensors are `record_stream`ed to the streams that read them, and the
next round's copies in wait for this round's last copy back, since both
touch the same pinned buffers. Read the states on the host only after
`torch.cuda.synchronize()`. A failed pin, stream or copy raises; there
is no unpinned mode. On the CPU (the tests) host memory is the device's:
the states stay where they are and the chunks are updated in turn, with
the same arithmetic.
"""
import torch

from ..device import resolve_dtype

__all__ = ["OffloadTrainStep"]


def _tensors(state):
    return [v for v in state.values() if isinstance(v, torch.Tensor)]


class OffloadTrainStep:
    """K-micro-step accumulation with a chunked, host-offloaded update.
    Attributes: `params` (the trainable parameters, in the model's
    order), `_chunks` (lists of indices into `params`), `pinned_bytes`
    (the states' bytes in pinned host memory; 0 on the CPU)."""

    def __init__(self, model, loss_fn, optimizer, accumulate_steps=1,
                 param_dtype=None, chunk_bytes=1 << 30):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.K = int(accumulate_steps)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        optimizer._bind_names(named)
        self.params = [p for _, p in named]
        if param_dtype is not None:
            dt = resolve_dtype(param_dtype)
            for p in self.params:
                if p.is_floating_point():
                    p.data = p.data.to(dt)
        self.device = self.params[0].device
        self._cuda = self.device.type == "cuda"
        self._states = [optimizer._get_state(p) for p in self.params]
        self.pinned_bytes = 0
        if self._cuda:
            self._pin_states()
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        self._d2h_done = None
        self._acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in self.params]
        self._chunks = self._pack_chunks(chunk_bytes)
        self._micro_count = 0

    def _pin_states(self):
        """Move every state tensor into one pinned host buffer per
        dtype; the states become views of it."""
        by_dtype = {}
        for st in self._states:
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    by_dtype.setdefault(v.dtype, []).append((st, k, v))
        for dt, items in by_dtype.items():
            flat = torch.empty(sum(v.numel() for _, _, v in items),
                               dtype=dt, pin_memory=True)
            off = 0
            for st, k, v in items:
                view = flat[off:off + v.numel()].view(v.shape)
                view.copy_(v)
                st[k] = view
                off += v.numel()
            self.pinned_bytes += flat.numel() * flat.element_size()

    def _pack_chunks(self, chunk_bytes):
        """Greedy packing of consecutive parameters: parameter +
        accumulator + state bytes (a host scalar counts 4) under
        `chunk_bytes`, a parameter larger than that alone."""
        chunks, cur, cur_b = [], [], 0
        for i, (p, st) in enumerate(zip(self.params, self._states)):
            n = p.numel()
            b = n * p.element_size() + n * 4 + sum(
                (v.numel() if isinstance(v, torch.Tensor) else 1) * 4
                for v in st.values())
            if cur and cur_b + b > chunk_bytes:
                chunks.append(cur)
                cur, cur_b = [], 0
            cur.append(i)
            cur_b += b
        if cur:
            chunks.append(cur)
        return chunks

    def __call__(self, *batch):
        from ..generation import release
        release(self.model)     # generate's kept decode buffers and graphs
        for p in self.params:
            p.grad = None
        loss = self.loss_fn(*batch)
        loss.backward()
        with torch.no_grad():
            for a, p in zip(self._acc, self.params):
                if p.grad is not None:
                    a.add_(p.grad)
                    p.grad = None
        self._micro_count += 1
        if self._micro_count >= self.K:
            self._micro_count = 0
            self._apply_update()
        return loss.detach()

    @torch.no_grad()
    def _apply_update(self):
        torch._foreach_div_(self._acc, float(self.K))
        if self._cuda:
            self._streamed_update()
        else:
            for idxs in self._chunks:
                self._update(idxs, [self._states[i] for i in idxs])
        torch._foreach_zero_(self._acc)

    def _update(self, idxs, states):
        self.optimizer.update([self.params[i] for i in idxs],
                              [self._acc[i] for i in idxs], states)

    def _streamed_update(self):
        main = torch.cuda.current_stream(self.device)
        h2d, d2h = self._h2d, self._d2h
        if self._d2h_done is not None:
            # the pinned states are read again only once last round's
            # copies back have landed in them
            h2d.wait_event(self._d2h_done)

        def fetch(idxs):
            with torch.cuda.stream(h2d):
                dev = [{k: v.to(self.device, non_blocking=True)
                        if isinstance(v, torch.Tensor) else v
                        for k, v in self._states[i].items()} for i in idxs]
                ready = h2d.record_event()
            for st in dev:
                for v in _tensors(st):
                    v.record_stream(main)
                    v.record_stream(d2h)
            return dev, ready

        pending = fetch(self._chunks[0])
        for n, idxs in enumerate(self._chunks):
            dev, ready = pending
            if n + 1 < len(self._chunks):
                pending = fetch(self._chunks[n + 1])
            main.wait_event(ready)
            self._update(idxs, dev)
            d2h.wait_event(main.record_event())
            with torch.cuda.stream(d2h):
                for i, st in zip(idxs, dev):
                    host = self._states[i]
                    for k, v in st.items():
                        if isinstance(v, torch.Tensor):
                            host[k].copy_(v, non_blocking=True)
                        else:
                            host[k] = v
        self._d2h_done = d2h.record_event()
