"""Continuous-batching serving engine over the paged KV cache.

The port of paddle_tpu/serving/engine.py. A long-lived engine holds a
fixed batch of decode SLOTS; requests flow through them at token
granularity (scheduler.py) with their K/V in the shared block arenas
(kv_cache.py). Every `step()` reaps cancelled and expired requests,
admits waiting ones, runs at most one chunked-prefill dispatch and one
decode batch.

Numerics: the per-layer math is the JAX engine's `block_step` — the same
ln1/project_qkv/out_proj/_add_ln2/mlp/lm_head modules — with attention
through the paged kernels (`ops.paged_attention`): on the card their
CUDA kernels, on the CPU their plain versions, which copy the JAX
gather+dense fallbacks. Greedy selection is the JAX engine's greedy
program: f32 argmax, log-softmax logp. In f32 on the CPU the streams are
token-identical to the JAX engine's on the same weights.

Device state: the arenas are updated in place (`index_put_`); PyTorch
runs eagerly, so the JAX engine's compiled programs, donation and
compile observatory have no counterpart here.

Weight-only int8 (`weights="wo8"`) quantizes the caller's model in
place with `quant.quantize_for_decode` (linears) before the compute-dtype
copy is made, as the JAX engine does, so the int8 codes come from the
model's own weights and never from bf16-rounded ones. A model quantized
beforehand with `quantize_weights_int8(model, embeddings=True)` serves
its tied head through the `int8_matvec` kernel on the card.

This slice serves greedy requests. Sampled decoding, the background
serve loop (start/stop/drain/restart), the HTTP front, metrics gauges
and request tracing come in later slices.
"""
import copy
import threading
import time

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..ops.paged_attention import flash_prefill_chunk, paged_decode_attention
from ..quant import quantize_for_decode
from .kv_cache import NULL_BLOCK, BlockPool, PagedKVCache, PrefixIndex
from .resilience import (AdmissionController, DeadlineExceededError,
                         RequestCancelledError)
from .scheduler import (CANCELLED, EXPIRED, FINISHED, PREFILL,
                        TERMINAL_STATES, Request, RequestHandle,
                        SamplingParams, Scheduler)

__all__ = ["EngineConfig", "ServingEngine"]


class EngineConfig:
    """Engine shape/capacity knobs, fixed at construction.

    `device=None` serves from the CUDA card (raises without one);
    `dtype=None` computes in the model's own dtype, "bfloat16" casts a
    copy of the weights and the KV arenas to bf16. `weights="wo8"`
    serves weight-only int8 linears (the model is quantized in place)."""

    def __init__(self, max_slots=4, block_size=16, num_blocks=None,
                 max_model_len=None, prefill_chunk=32, dtype="bfloat16",
                 weights="native", device=None, max_queue=None,
                 enable_prefix_cache=True):
        if weights not in ("native", "wo8"):
            raise ValueError(f"weights must be 'native' or 'wo8', got "
                             f"{weights!r}")
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.num_blocks = num_blocks
        self.max_model_len = max_model_len
        self.prefill_chunk = int(prefill_chunk)
        self.dtype = dtype
        self.weights = weights
        self.device = device
        # bounded waiting queue (None -> 16x slots)
        self.max_queue = 16 * self.max_slots if max_queue is None \
            else int(max_queue)
        # prefix-sharing KV cache (copy-on-write block reuse across
        # requests); off, the index is simply never consulted
        self.enable_prefix_cache = bool(enable_prefix_cache)


def _serving_copy(model, device, dtype):
    """The weights the engine computes with: `model` itself when it
    already lives on `device` in `dtype`, else a converted copy (the JAX
    engine casts inside its compiled step; here the cast is done once)."""
    p = next(model.parameters())
    if p.device == device and p.dtype == dtype:
        return model
    return copy.deepcopy(model).to(device=device, dtype=dtype)


def _block_step(block, h, attend, write):
    """One GPTBlock over the paged cache: the JAX engine's block_step
    (engine.py:324-335). K/V are written first, then attended."""
    y = block.ln1(h)
    q, k, v = block.attn.project_qkv(y)
    write(k, v)
    a = block.attn.out_proj(attend(q))
    y2, h2 = block._add_ln2(h, block.dropout(a))
    return h2 + block.dropout(block.mlp(y2))


def _greedy(last):
    """Greedy selection over f32 logits [B, V] -> (token, logp)."""
    lg = last.float()
    tok = torch.argmax(lg, dim=-1)
    logp = torch.log_softmax(lg, dim=-1).gather(1, tok[:, None])[:, 0]
    return tok, logp


class ServingEngine:
    """submit(prompt, params) -> streaming RequestHandle; step() runs one
    scheduler iteration (one prefill chunk + one decode batch).

    `model` is a `models.gpt.GPTForPretraining` (or anything exposing its
    `.gpt` core — wte/wpe/drop/blocks/ln_f — and `.lm_head`)."""

    def __init__(self, model, config=None, **overrides):
        self.cfg = config or EngineConfig(**overrides)
        cfg = self.cfg
        self.device = resolve_device(cfg.device)
        mcfg = model.config
        self.n_heads = mcfg.num_heads
        self.hidden = mcfg.hidden_size
        self.max_model_len = int(cfg.max_model_len or mcfg.max_seq_len)
        self.block_size = cfg.block_size
        self.max_blocks_per_seq = PagedKVCache.blocks_for_tokens(
            self.max_model_len, self.block_size)
        self._compute_dtype = resolve_dtype(cfg.dtype or mcfg.dtype)
        if cfg.weights == "wo8":
            quantize_for_decode(model)
        self._net = _serving_copy(model, self.device, self._compute_dtype)

        num_blocks = self._resolve_num_blocks()
        self.pool = BlockPool(num_blocks)   # guarded by: _mu
        self.cache = PagedKVCache(          # guarded by: _mu
            mcfg.num_layers, num_blocks, self.block_size, self.hidden,
            dtype=self._compute_dtype, device=self.device)
        self.prefix_index = (
            PrefixIndex(self.block_size, pool=self.pool)
            if cfg.enable_prefix_cache else None)
        self.sched = Scheduler(self.pool, self.block_size, cfg.max_slots,
                               self.max_model_len,
                               prefix_index=self.prefix_index)
        # one step at a time; submit/cancel from other threads serialize
        # against it
        self._mu = threading.RLock()
        self.admission = AdmissionController(cfg.max_queue, cfg.max_slots)
        # prefix-cache accounting: offered = positions each admission
        # would have to prefill cold, saved = positions a hit covered
        self._prefix_stats = {"lookups": 0, "hits": 0,
                              "tokens_saved": 0, "tokens_offered": 0}
        # device dispatches run so far (one attention launch per layer
        # each)
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.kv_peak_utilization = 0.0

    def _resolve_num_blocks(self):
        if self.cfg.num_blocks is not None:
            return int(self.cfg.num_blocks)
        # default: every slot can hold a full-length sequence (+ null)
        return self.cfg.max_slots * self.max_blocks_per_seq + 1

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, prompt_ids, params=None, deadlines=None,
               priority="normal", request_id=None, **kw):
        """Queue one greedy generation; returns a RequestHandle whose
        `.tokens()` stream yields ids as the engine emits them. Raises
        `ShedError`/`QueueFullError` when admission control rejects the
        request, ValueError when it can never fit this engine."""
        params = params or SamplingParams(**kw)
        if not params.greedy:
            raise NotImplementedError(
                "decode_strategy='sampling' comes in a later slice of the "
                "port; this engine serves greedy requests only")
        req = Request(prompt_ids, params, deadlines=deadlines,
                      priority=priority, request_id=request_id)
        if req.request_id is None:
            req.request_id = f"r{req.rid}"
        with self._mu:
            self.sched.validate(req)        # client error, not load
            self.admission.admit_or_raise(req, self.sched.waiting)
            self.sched.enqueue(req)
        return RequestHandle(req, engine=self)

    def cancel(self, req):
        """Cancel `req` (RequestHandle.cancel lands here): its slot and KV
        blocks go back to the pool now and its stream ends with
        `RequestCancelledError`."""
        with self._mu:
            if req.state in TERMINAL_STATES:
                return False
            req.cancel_requested = True
            self._finalize(req, CANCELLED,
                           exc=RequestCancelledError(
                               f"request {req.rid} cancelled after "
                               f"{len(req.out_tokens)} token(s)"))
        return True

    # ------------------------------------------------------------------
    # the engine loop
    # ------------------------------------------------------------------
    def step(self):
        """One scheduler iteration: reap (cancellations + deadlines),
        admit, at most one prefill chunk, one decode batch. Returns True
        when any device work was done."""
        with self._mu:
            now = time.monotonic()
            self._reap(now)
            admitted = self.sched.admit(now=now)
            if self.prefix_index is not None:
                ps = self._prefix_stats
                for req in admitted:
                    ps["lookups"] += 1
                    ps["tokens_offered"] += len(req.tokens_all)
                    if req.prefix_cached_tokens:
                        ps["hits"] += 1
                        ps["tokens_saved"] += req.prefix_cached_tokens
            did = self._prefill_one()
            did = self._decode_once() or did
            self.kv_peak_utilization = max(self.kv_peak_utilization,
                                           self.pool.utilization())
            return did

    def run_until_idle(self, max_steps=None):
        n = 0
        while self.sched.has_work():
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        return n

    def _reap(self, now):     # requires: _mu
        for req, why in self.sched.reap(now):
            if why == "cancelled":
                self._finalize(req, CANCELLED,
                               exc=RequestCancelledError(
                                   f"request {req.rid} cancelled after "
                                   f"{len(req.out_tokens)} token(s)"))
            else:
                self._finalize(req, EXPIRED,
                               exc=DeadlineExceededError(
                                   f"request {req.rid} blew its {why} "
                                   f"deadline ({req.deadlines!r})",
                                   which=why))

    def prefix_stats(self):
        """Prefix-cache accounting: lookups, hits, tokens saved/offered,
        hit_rate (saved / offered), shared/cached block counts."""
        with self._mu:
            ps = dict(self._prefix_stats)
            offered = ps["tokens_offered"]
            ps["hit_rate"] = ps["tokens_saved"] / offered \
                if offered else 0.0
            ps["blocks_shared"] = self.pool.num_shared
            ps["blocks_cached"] = self.pool.num_cached
            return ps

    # ------------------------------------------------------------------
    # host-side step logic (the JAX engine's, unchanged)
    # ------------------------------------------------------------------
    def _cow_fork(self, req, bi, evict=True):     # requires: _mu
        """Copy-on-write: make `req.blocks[bi]` safe to write. A block
        another request (or the prefix index) can read is never mutated:
        fork it into a fresh private block, swap the table entry, and
        drop this request's reference to the original. Block acquisition
        follows the `ensure_blocks` reclaim ladder — index leaves first,
        then preemption only when `evict` allows it. Returns False when
        the chunk must wait (or the request yielded its own place)."""
        pool = self.sched.pool
        old = req.blocks[bi]
        if pool.is_private(old, req.rid):
            return True
        while True:
            got = pool.alloc(1, owner=req.rid)
            if got is not None:
                break
            if self.prefix_index is not None and \
                    self.prefix_index.evict(1, pool):
                continue
            if not evict:
                return False                # wait for free blocks
            victim = self.sched._pick_victim(exclude=req)
            if victim is None:
                self.sched.preempt(req)     # yield; replay re-matches
                return False
            self.sched.preempt(victim)
        new = got[0]
        self.cache.copy_block(old, new)
        pool.free([old], owner=req.rid)
        req.blocks[bi] = new
        return True

    def _prefill_one(self):     # requires: _mu
        sched = self.sched
        # prefill growth normally WAITS for blocks instead of evicting;
        # with nothing decoding, the oldest prefill may evict its way
        # forward (else a pool held by fellow prefills would deadlock)
        allow_evict = sched.num_running() == 0
        for idx, req in enumerate(list(sched.prefilling)):
            seq = req.tokens_all
            p0 = req.n_prefilled
            c_real = min(self.cfg.prefill_chunk, len(seq) - p0)
            if c_real <= 0:                     # defensive; place it
                sched.place(req)
                continue
            if not sched.ensure_blocks(req, p0 + c_real,
                                       evict=allow_evict and idx == 0):
                continue                        # wait for free blocks
            # a prefix hit may resume INSIDE a shared block: fork before
            # the chunk writes into it (blocks past p0's are fresh)
            bi = p0 // self.block_size
            if bi < len(req.blocks) and not self._cow_fork(
                    req, bi, evict=allow_evict and idx == 0):
                continue                        # wait / yielded
            C = self.cfg.prefill_chunk
            ids = np.zeros((C,), np.int32)
            ids[:c_real] = seq[p0:p0 + c_real]
            tok, logp = self._prefill_chunk(ids, p0, c_real,
                                            self._table_row(req))
            self.prefill_chunks += 1
            req.n_prefilled = p0 + c_real
            if req.n_prefilled >= len(seq):
                # publish the full prompt blocks to the prefix index,
                # then stream the token sampled from the last position
                sched.note_prefill_done(req)
                self._emit(req, tok, logp)
                if req.state == PREFILL:    # _emit finishes done ones
                    sched.place(req)
            return True
        return False

    def _decode_once(self):     # requires: _mu
        sched = self.sched
        # grow blocks oldest-first so eviction lands on the youngest
        for req in list(sched.admit_order):
            if req.slot is None:
                continue
            sched.ensure_blocks(req, req.n_prefilled + 1, evict=True)
            # decode writes position n_prefilled: defensively fork a
            # still-shared tail (normally prefill already forked it)
            bi = req.n_prefilled // self.block_size
            if req.slot is not None and bi < len(req.blocks):
                self._cow_fork(req, bi)
        active = [(i, r) for i, r in enumerate(sched.running)
                  if r is not None]
        if not active:
            return False
        S = self.cfg.max_slots
        mb = self.max_blocks_per_seq
        # inactive slots decode token 0 at position 0 through an all-null
        # table: their writes land in the null block, their outputs are
        # finite and ignored
        tokens = np.zeros((S,), np.int32)
        ctx = np.zeros((S,), np.int32)
        tables = np.full((S, mb), NULL_BLOCK, np.int32)
        for i, req in active:
            tokens[i] = req.tokens_all[req.n_prefilled]
            ctx[i] = req.n_prefilled
            tables[i, :len(req.blocks)] = req.blocks
        tok, logp = self._decode_step(tokens, ctx, tables)
        self.decode_steps += 1
        now = time.monotonic()
        for i, req in active:
            req.n_prefilled += 1
            self._emit(req, int(tok[i]), float(logp[i]), now=now)
        return True

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _decode_step(self, tokens, ctx, tables):
        """One decode token for every slot: write each slot's K/V at
        (table[ctx // bs], ctx % bs), attend over its blocks, select
        greedily. Returns host arrays (tokens [S], logp [S])."""
        core = self._net.gpt
        S, nh, bs = self.cfg.max_slots, self.hidden, self.block_size
        # one host->device copy for all step inputs
        packed = torch.from_numpy(
            np.concatenate([tokens[:, None], ctx[:, None], tables], axis=1)
        ).to(self.device)
        tok_d = packed[:, 0]
        ctx_d = packed[:, 1].contiguous()
        tab_d = packed[:, 2:].contiguous()
        ctx_l = ctx_d.long()
        blk = tab_d.long().gather(1, (ctx_l // bs)[:, None])[:, 0]
        off = ctx_l % bs
        h = core.drop(core.wte(tok_d[:, None]) + core.wpe(ctx_d[:, None]))
        for li, block in enumerate(core.blocks):
            kp, vp = self.cache.k[li], self.cache.v[li]

            def write(k, v, kp=kp, vp=vp):
                kp.index_put_((blk, off), k.reshape(S, nh).to(kp.dtype))
                vp.index_put_((blk, off), v.reshape(S, nh).to(vp.dtype))

            def attend(q, kp=kp, vp=vp):
                return paged_decode_attention(
                    q.reshape(S, 1, nh).contiguous(), kp, vp, tab_d, ctx_d,
                    self.n_heads)

            h = _block_step(block, h, attend, write)
        last = self._net.lm_head(core.ln_f(h))[:, -1]
        tok, logp = _greedy(last)
        return tok.cpu().numpy(), logp.cpu().numpy()

    @torch.inference_mode()
    def _prefill_chunk(self, ids, p0, n_real, table_row):
        """One chunk of ONE request: ids [C] (the tail past n_real is
        padding, written to the null block) at positions p0..p0+C-1.
        Returns the greedy token and its logp from the last real
        position — used by the caller only after the final chunk."""
        core = self._net.gpt
        C, nh, bs = self.cfg.prefill_chunk, self.hidden, self.block_size
        mb = self.max_blocks_per_seq
        positions = p0 + np.arange(C, dtype=np.int32)
        blk = np.where(np.arange(C) < n_real,
                       table_row[np.clip(positions // bs, 0, mb - 1)],
                       NULL_BLOCK).astype(np.int32)
        packed = torch.from_numpy(np.concatenate(
            [ids, positions, blk, positions % bs, table_row])).to(
                self.device)
        ids_d, pos_d = packed[:C], packed[C:2 * C]
        blk_d, off_d = packed[2 * C:3 * C].long(), packed[3 * C:4 * C].long()
        tab_d = packed[4 * C:]
        h = core.drop(core.wte(ids_d[None]) + core.wpe(pos_d[None]))
        for li, block in enumerate(core.blocks):
            kp, vp = self.cache.k[li], self.cache.v[li]

            def write(k, v, kp=kp, vp=vp):
                kp.index_put_((blk_d, off_d), k.reshape(C, nh).to(kp.dtype))
                vp.index_put_((blk_d, off_d), v.reshape(C, nh).to(vp.dtype))

            def attend(q, kp=kp, vp=vp):
                return flash_prefill_chunk(
                    q.reshape(1, C, nh).contiguous(), kp, vp, tab_d, p0,
                    self.n_heads)

            h = _block_step(block, h, attend, write)
        hf = core.ln_f(h)
        last = self._net.lm_head(hf[:, n_real - 1:n_real])[:, -1]
        tok, logp = _greedy(last)
        return int(tok[0]), float(logp[0])

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _table_row(self, req):
        row = np.full((self.max_blocks_per_seq,), NULL_BLOCK, np.int32)
        row[:len(req.blocks)] = req.blocks
        return row

    def _finalize(self, req, status, exc=None):     # requires: _mu
        """The single terminal transition: release slot + blocks via the
        scheduler and close the stream. Idempotent."""
        if req.state in TERMINAL_STATES:
            return
        self.sched.finish(req, status=status, failure=exc)

    def _emit(self, req, tok, logp, now=None):     # requires: _mu
        req.push_token(tok, now=now)
        if req.done:
            self._finalize(req, FINISHED)
            self.admission.note_tpot_ms(req.tpot_ms())
