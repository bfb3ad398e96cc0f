"""Continuous-batching scheduler over the paged KV cache (the port of
torchacc_tpu/serve/scheduler.py).

A host-side loop owns every decision — admission into free slots, which
sequences prefill this iteration, eviction, block free and reuse — and
drives eager device steps (:class:`PagedDecoder`):

- ``decode``: one token for every slot in one batched step.  Sampling
  runs on the device and the sampled tokens feed the next iteration as
  a device tensor — the token loop never waits for the host.
- ``prefill``: a chunk of up to ``serve.prefill_chunk`` tokens of one
  sequence, or (``serve.prefill_batch > 1``) one chunk each of several
  sequences in one step, interleaved with decode.  Rows are padded to
  the longest chunk of the step, not to the full ``[prefill_batch,
  prefill_chunk]`` geometry the JAX package keeps for its one trace;
  pad tokens write to the null block as there.
- ``cow``: copy one block's k/v across all layers (the copy-on-write
  behind a fully cached prompt).

Pools are updated IN PLACE: where JAX donates the pools to each step
and gets new ones back, the port writes with ``index_put_``/``copy_``
into the one preallocated ``[L, NB, BS, KH, D]`` pair.  The pool is
written before attention reads it, and block 0 (the null block)
absorbs the writes of free slots and pad tokens, so it is never handed
out.

Host reads happen at lag ``serve.decode_depth - 1`` through the
in-flight ring.  On CUDA, ``tensor.cpu()`` would wait for all queued
work, so each ring entry copies its tokens ``non_blocking`` into pinned
host memory and records a CUDA event; resolution waits on that event
only.  Host-to-device uploads go the same way (pinned, non-blocking)
so that no upload waits for the queue either.  A finished sequence's
blocks are freed deferred — only after every dispatched iteration that
could still write through its old table has resolved.

Prefix cache (``serve.prefix_cache``): admission maps the longest
hash-chain match of a new prompt onto resident blocks; when the match
covers the whole prompt, the last matched block is copied into a
private one and only the final prompt token re-runs.

Left out of this slice (ROADMAP.md): tracing spans, chaos failpoints,
deadline preemption and the mesh/TP sharding of the pools.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torchacc_tpu_torch.models.generate import embed, sample_slots
from torchacc_tpu_torch.models.transformer import (
    ModelConfig,
    head_logits,
    rms_norm,
    rope,
)
from torchacc_tpu_torch.ops.paged_attention import paged_attention
from torchacc_tpu_torch.serve.kv_cache import (
    BlockPool,
    PrefixIndex,
    blocks_needed,
    make_pools,
)
from torchacc_tpu_torch.utils.logger import logger
from torchacc_tpu_torch.utils.metrics import counters

# ModelConfig fields the paged forward implements for any value
_SUPPORTED_FIELDS = frozenset({
    "vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads",
    "head_dim", "intermediate_size", "max_seq_len", "rope_theta",
    "rope_scale", "norm_eps", "qkv_bias", "tie_embeddings",
    "attn_logit_softcap", "query_scale", "dtype", "param_dtype",
})
# fields that select training-time execution only and cannot change
# what the serving forward computes (the JAX package's audit:
# scheduler.py _AUDITED_MODEL_FIELDS); the MoE knobs are inert while
# num_experts == 0, norm_bias without a layernorm
_INERT_FIELDS = frozenset({
    "scan_layers", "remat", "remat_policy", "remat_cls", "remat_cnt",
    "attention_impl", "decode", "cache_len", "attn_dropout", "quant",
    "quant_sites", "quant_amax_history_len", "quant_impl", "overlap_fsdp",
    "pp_num_micro", "pp_virtual", "logical_axis_rules", "tp_vocab_head",
    "num_experts_per_tok", "router_aux_weight", "moe_dispatch",
    "moe_renorm_topk", "moe_capacity_factor", "parallel_block_shared_norm",
    "norm_bias",
})


def _check_supported(cfg: ModelConfig) -> None:
    """The serving surface of this slice, as an allow-list: rmsnorm,
    swiglu, plain RoPE, GQA, qkv_bias, tied embeddings and the attention
    softcap.  Every other field must keep its default; one that does not
    raises NotImplementedError naming it."""
    bad = []
    for f in dataclasses.fields(cfg):
        if f.name in _SUPPORTED_FIELDS or f.name in _INERT_FIELDS:
            continue
        value = getattr(cfg, f.name)
        if value != f.default:
            bad.append(f"{f.name}={value!r}")
    if bad:
        raise NotImplementedError(
            "the serving engine of torchacc_tpu_torch does not support "
            + ", ".join(bad) + " (it implements rmsnorm, swiglu, plain "
            "RoPE, GQA, qkv_bias, tie_embeddings and attn_logit_softcap)")


class PagedDecoder:
    """The device steps: the model's forward over the paged pool, eager,
    in place on the pools, under the caller's ``torch.inference_mode``."""

    def __init__(self, model, serve_cfg, attention_impl: Optional[str] = None):
        cfg = model.cfg
        _check_supported(cfg)
        self.model = model
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.impl = attention_impl or cfg.attention_impl
        self.block_size = serve_cfg.block_size

    # -- model forward ------------------------------------------------------

    def _dense(self, x, lin: torch.nn.Linear):
        """Both operands in the compute dtype (``_dense``)."""
        dt = self.cfg.dtype
        y = F.linear(x.to(dt), lin.weight.to(dt))
        if lin.bias is not None:
            y = y + lin.bias.to(dt)
        return y

    def _layer(self, layer, x, positions, kp, vp, tables, ctx_lens,
               flat_b, flat_o):
        """One decoder layer; ``flat_b``/``flat_o`` name the pool slot
        each token writes its k/v to (the null block for masked ones)."""
        cfg = self.cfg
        s_, t_ = x.shape[:2]
        kh, d = cfg.kv_heads, cfg.head_size
        h = rms_norm(cfg, x, layer.ln1.weight)
        attn = layer.attn
        q = self._dense(h, attn.q_proj).view(s_, t_, cfg.num_heads, d)
        k = self._dense(h, attn.k_proj).view(s_, t_, kh, d)
        v = self._dense(h, attn.v_proj).view(s_, t_, kh, d)
        rp = (positions.float() / cfg.rope_scale if cfg.rope_scale != 1.0
              else positions)
        q, k = rope(q, k, rp, cfg)
        # bank this chunk's rotated k / raw v, then attend over the pool
        kp[flat_b, flat_o] = k.reshape(s_ * t_, kh, d).to(kp.dtype)
        vp[flat_b, flat_o] = v.reshape(s_ * t_, kh, d).to(vp.dtype)
        out = paged_attention(
            q, kp, vp, tables, ctx_lens, positions[:, 0],
            scale=cfg.query_scale, window=cfg.window,
            logit_softcap=cfg.attn_logit_softcap, impl=self.impl)
        x = x + self._dense(out.reshape(s_, t_, -1), attn.o_proj)
        h2 = rms_norm(cfg, x, layer.ln2.weight)
        mlp = layer.mlp
        ff = (F.silu(self._dense(h2, mlp.gate_proj))
              * self._dense(h2, mlp.up_proj))
        return x + self._dense(ff, mlp.down_proj)

    def forward(self, pools, ids, positions, tables, ctx_lens, blk, off):
        """Hidden ``[S, T, h]`` after every layer; writes each layer's
        k/v for the ``[S, T]`` tokens into ``pools`` at (blk, off)."""
        x = embed(self.cfg, self.model, ids)
        k_pools, v_pools = pools
        flat_b, flat_o = blk.reshape(-1).long(), off.reshape(-1).long()
        for i, layer in enumerate(self.model.layers):
            x = self._layer(layer, x, positions, k_pools[i], v_pools[i],
                            tables, ctx_lens, flat_b, flat_o)
        return x

    # -- steps --------------------------------------------------------------

    def decode(self, pools, tok, tables, seq_lens, active, temp, top_k,
               top_p, seeds, all_greedy: bool):
        """One token for every slot.  ``seq_lens`` is the banked length
        BEFORE this token; free slots (active False) run on the null
        block and their tokens are ignored by the host."""
        bs = self.block_size
        idx = (seq_lens // bs).clamp(max=tables.shape[1] - 1).long()
        blk = torch.where(active, tables.gather(1, idx[:, None])[:, 0], 0)
        off = torch.where(active, seq_lens % bs, 0)
        ctx = torch.where(active, seq_lens + 1, 0)
        x = self.forward(pools, tok[:, None], seq_lens[:, None], tables, ctx,
                         blk[:, None], off[:, None])
        logits = head_logits(self.cfg, self.model, x)[:, 0]
        if all_greedy:
            return logits.argmax(dim=-1).to(torch.int32)
        # the token being sampled sits at position seq_lens + 1
        return sample_slots(logits, temp, top_k, top_p, seeds, seq_lens + 1)

    def prefill(self, pools, table_rows, t0s, tokens, n_valids,
                with_head: bool):
        """One chunk each of ``R`` sequences: bank k/v for tokens
        ``[t0, t0 + n_valid)`` of each row and return the last valid
        row's f32 logits ``[R, V]`` (None without the head: a non-final
        single chunk needs no logits).  Pad tokens (column >= n_valid)
        write to the null block and their positions clamp to the row's
        newest real position."""
        bs = self.block_size
        c = tokens.shape[1]
        i = torch.arange(c, dtype=torch.int32, device=tokens.device)[None]
        valid = i < n_valids[:, None]
        pos = t0s[:, None] + i
        last_pos = (t0s + n_valids - 1).clamp(min=0)[:, None]
        positions = torch.where(valid, pos, last_pos)
        page = (pos // bs).clamp(max=table_rows.shape[1] - 1).long()
        blk = torch.where(valid, table_rows.gather(1, page), 0)
        off = torch.where(valid, pos % bs, 0)
        x = self.forward(pools, tokens, positions, table_rows, t0s + n_valids,
                         blk, off)
        if not with_head:
            return None
        last = (n_valids - 1).clamp(min=0).long()
        rows = torch.arange(x.shape[0], device=x.device)
        return head_logits(self.cfg, self.model, x[rows, last][:, None])[:, 0]

    def cow(self, pools, src: int, dst: int) -> None:
        """Copy block ``src``'s k/v into block ``dst`` in every layer."""
        for p in pools:
            p[:, dst].copy_(p[:, src])


@dataclasses.dataclass
class Sequence:
    """Host-side runtime state of one admitted request."""

    sid: int
    prompt: np.ndarray                       # int32 [P]
    max_new: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    seed: int = 0
    # 'priority' policy inputs; deadline is absolute host monotonic time
    priority: int = 0
    deadline: float = float("inf")
    # streaming: on_token(token, t_monotonic) as the ring resolves each
    on_token: Any = None
    # runtime
    slot: int = -1
    blocks: List[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""
    # prefix-cache runtime (admit() fills these)
    block_keys: Optional[List[bytes]] = None
    registered: int = 0
    cached_tokens: int = 0
    shared_blocks: int = 0
    cow: bool = False
    # metrics timestamps (host monotonic clock)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


def priority_key(seq: Sequence, now: float, aging_s: float):
    """'priority' ordering: effective class descending (declared class
    + 1 per ``aging_s`` waited), then earliest deadline, then arrival."""
    eff = seq.priority + (int((now - seq.t_submit) / aging_s)
                          if aging_s > 0 else 0)
    return (-eff, seq.deadline, seq.sid)


class _Readback:
    """Host copy of one iteration's tokens that waits for that
    iteration only: on CUDA a non-blocking copy into pinned memory plus
    an event; on the CPU a private copy (the carry is later written in
    place)."""

    def __init__(self, toks: torch.Tensor):
        self.event = None
        if toks.device.type == "cuda":
            self.host = torch.empty(toks.shape, dtype=toks.dtype,
                                    pin_memory=True)
            self.host.copy_(toks, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = toks.clone()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unresolved iteration in the readback ring."""

    kind: str                                # 'decode' | 'first'
    tokens: _Readback
    slots: List[Tuple[int, Sequence]] = dataclasses.field(
        default_factory=list)
    seq: Optional[Sequence] = None
    iter_idx: int = -1
    t_dispatch: float = 0.0


class Scheduler:
    """Slot + block bookkeeping and the iteration loop.  One ``step()``
    = at most one prefill dispatch + one batched decode + ring
    resolution down to ``decode_depth - 1`` in flight."""

    def __init__(self, model, serve_cfg, device: torch.device,
                 attention_impl: Optional[str] = None, blocked=None):
        self.cfg = model.cfg
        self.serve_cfg = serve_cfg
        self.device = device
        self.blocked = blocked
        self.decoder = PagedDecoder(model, serve_cfg, attention_impl)
        self.prefix = (PrefixIndex(serve_cfg.block_size)
                       if serve_cfg.prefix_cache else None)
        self.pool = BlockPool(serve_cfg.num_blocks, index=self.prefix)
        self.k_pools, self.v_pools = make_pools(self.cfg, serve_cfg, device)
        s = serve_cfg.max_slots
        # table width bounds the longest admissible sequence (the
        # model's position reach plus the in-flight overhang), not the
        # pool, so a bigger pool does not widen every slot's table
        self.max_blocks_per_seq = min(
            serve_cfg.num_blocks - 1,
            blocks_needed(self.cfg.max_seq_len + serve_cfg.decode_depth,
                          serve_cfg.block_size))
        self.tables = np.zeros((s, self.max_blocks_per_seq), np.int32)
        self.seq_lens = np.zeros((s,), np.int32)
        self.active = np.zeros((s,), bool)
        self.temp = np.zeros((s,), np.float32)
        self.top_k = np.zeros((s,), np.int32)
        self.top_p = np.ones((s,), np.float32)
        self.seeds = np.zeros((s,), np.int64)
        self.slot_seq: List[Optional[Sequence]] = [None] * s
        self.carry = torch.zeros((s,), dtype=torch.int32, device=device)
        self._ring: "collections.deque[_InFlight]" = collections.deque()
        self._iter = 0            # decode iterations dispatched
        self._resolved = 0        # decode iterations resolved
        self.prefill_dispatches = 0
        self._deferred: List[Tuple[int, List[int]]] = []
        self.finished: List[Sequence] = []
        # device copies of tables/active/sampling params, re-uploaded
        # only when admission, prefill completion or eviction dirty them
        self._dev_stable = None

    @property
    def decode_dispatches(self) -> int:
        return self._iter

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the queue
        (pinned staging + non-blocking copy on CUDA)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # -- admission ----------------------------------------------------------

    def blocks_for(self, seq: Sequence) -> int:
        """Blocks reserved at admission: prompt + max_new + overhang."""
        return blocks_needed(
            seq.prompt_len + seq.max_new + self.serve_cfg.decode_depth,
            self.serve_cfg.block_size)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slot_seq):
            if s is None:
                return i
        return None

    def min_fresh_blocks(self, seq: Sequence) -> int:
        """Best-case fresh-block need (every full prompt block a hit)."""
        total = self.blocks_for(seq)
        if self.prefix is None:
            return total
        return max(1, total - seq.prompt_len // self.serve_cfg.block_size)

    def admit(self, seq: Sequence) -> bool:
        """Give ``seq`` a slot and its whole block reservation, or return
        False with no state change."""
        slot = self.free_slot()
        if slot is None:
            return False
        total = self.blocks_for(seq)
        shared: List[int] = []
        cow_src: Optional[int] = None
        if self.prefix is not None:
            if seq.block_keys is None:
                seq.block_keys = self.prefix.keys(seq.prompt)
            shared = self.prefix.match(seq.block_keys)
            if shared and (len(shared) * self.serve_cfg.block_size
                           >= seq.prompt_len):
                # fully cached prompt: the final token must re-run and
                # its k/v write needs a block this sequence owns
                cow_src = shared.pop()
        # pin the match BEFORE alloc: alloc may evict refcount-0 blocks
        for b in shared:
            self.pool.share(b)
        if cow_src is not None:
            self.pool.share(cow_src)
        fresh = self.pool.alloc(total - len(shared))
        if fresh is None:
            self.pool.free(shared)
            if cow_src is not None:
                self.pool.free([cow_src])
            return False
        blocks = shared + fresh
        seq.slot = slot
        seq.blocks = blocks
        seq.t_admit = time.monotonic()
        cached = len(shared) * self.serve_cfg.block_size
        if cow_src is not None:
            # dst = fresh[0] sits where the popped match sat; stream
            # order makes the copy read src before anything recycles it
            self.decoder.cow((self.k_pools, self.v_pools), cow_src, fresh[0])
            self.pool.free([cow_src])
            cached = seq.prompt_len - 1
            seq.cow = True
            counters.inc("cow_copies")
        seq.prefilled = cached
        seq.cached_tokens = cached
        seq.shared_blocks = len(shared)
        seq.registered = len(shared)
        if cached:
            counters.inc("prefix_hits")
            if shared:
                counters.inc("prefix_blocks_reused", len(shared))
        self.slot_seq[slot] = seq
        self.tables[slot, :] = 0
        self.tables[slot, :len(blocks)] = blocks
        self.seq_lens[slot] = cached
        self.active[slot] = False          # decode starts after prefill
        self.temp[slot] = seq.temperature
        self.top_k[slot] = seq.top_k
        self.top_p[slot] = seq.top_p
        self.seeds[slot] = seq.seed
        self._dev_stable = None
        return True

    # -- the iteration ------------------------------------------------------

    def _prefill_candidates(self) -> List[Sequence]:
        """Up to ``prefill_batch`` sequences with prompt left to prefill,
        most urgent first."""
        cands = [s for s in self.slot_seq
                 if s is not None and not s.finished
                 and s.prefilled < s.prompt_len]
        if not cands:
            return []
        if self.serve_cfg.policy == "priority":
            now = time.monotonic()
            aging = self.serve_cfg.priority_aging_s
            cands.sort(key=lambda s: priority_key(s, now, aging))
        else:
            cands.sort(key=lambda s: s.sid)
        return cands[:self.serve_cfg.prefill_batch]

    def step(self) -> bool:
        """One engine iteration.  True when any device work was
        dispatched or resolved."""
        did = False
        seqs = self._prefill_candidates()
        if seqs:
            if len(seqs) == 1:
                self._prefill_one(seqs[0])
            else:
                self._prefill_batched(seqs)
            did = True
        if self.active.any():
            self._decode_once()
            did = True
        while len(self._ring) >= self.serve_cfg.decode_depth:
            self._resolve_one()
        if not did and self._ring:
            self._resolve_one()
            did = True
        self._release_matured()
        return did

    def _prefill_one(self, seq: Sequence) -> None:
        c = self.serve_cfg.prefill_chunk
        t0 = seq.prefilled
        chunk = seq.prompt[t0:t0 + c]
        n = int(chunk.shape[0])
        final = (t0 + n) >= seq.prompt_len
        logits = self.decoder.prefill(
            (self.k_pools, self.v_pools),
            self._upload(self.tables[seq.slot][None]),
            self._upload(np.asarray([t0], np.int32)),
            self._upload(chunk[None]),
            self._upload(np.asarray([n], np.int32)), with_head=final)
        self.prefill_dispatches += 1
        seq.prefilled += n
        self.seq_lens[seq.slot] = seq.prefilled
        self._register_prefix(seq)
        if final:
            self._seed_first_token(seq, logits[0])

    def _prefill_batched(self, seqs: List[Sequence]) -> None:
        """One chunk each of several sequences in one dispatch, rows
        padded to the longest chunk."""
        c = self.serve_cfg.prefill_chunk
        chunks = [s.prompt[s.prefilled:s.prefilled + c] for s in seqs]
        width = max(int(ch.shape[0]) for ch in chunks)
        toks = np.zeros((len(seqs), width), np.int32)
        for r, ch in enumerate(chunks):
            toks[r, :ch.shape[0]] = ch
        taken = [int(ch.shape[0]) for ch in chunks]
        logits = self.decoder.prefill(
            (self.k_pools, self.v_pools),
            self._upload(self.tables[[s.slot for s in seqs]]),
            self._upload(np.asarray([s.prefilled for s in seqs], np.int32)),
            self._upload(toks), self._upload(np.asarray(taken, np.int32)),
            with_head=True)
        self.prefill_dispatches += 1
        for r, seq in enumerate(seqs):
            seq.prefilled += taken[r]
            self.seq_lens[seq.slot] = seq.prefilled
            self._register_prefix(seq)
            if seq.prefilled >= seq.prompt_len:
                self._seed_first_token(seq, logits[r])

    def _register_prefix(self, seq: Sequence) -> None:
        """Index every newly completed FULL prompt block (first writer
        wins)."""
        if self.prefix is None or not seq.block_keys:
            return
        n_full = min(seq.prefilled, seq.prompt_len) \
            // self.serve_cfg.block_size
        while seq.registered < n_full:
            i = seq.registered
            self.prefix.register(seq.block_keys[i], seq.blocks[i])
            seq.registered += 1

    def _seed_first_token(self, seq: Sequence, last_logits) -> None:
        """Final prefill chunk done: sample the first token on the device
        and splice it into the decode carry — no readback here; the host
        learns it through the ring like any other token."""
        if seq.temperature <= 0:
            tok = last_logits.argmax().to(torch.int32)
        else:
            # the first generated token sits at position prompt_len
            tok = sample_slots(
                last_logits[None],
                self._upload(np.asarray([seq.temperature], np.float32)),
                self._upload(np.asarray([seq.top_k], np.int32)),
                self._upload(np.asarray([seq.top_p], np.float32)),
                self._upload(np.asarray([seq.seed], np.int64)),
                self._upload(np.asarray([seq.prompt_len], np.int64)))[0]
        self.carry[seq.slot] = tok
        self.active[seq.slot] = True
        self._dev_stable = None
        self._ring.append(_InFlight(
            kind="first", tokens=_Readback(tok), seq=seq,
            t_dispatch=time.monotonic()))

    def _dev_stable_arrays(self):
        if self._dev_stable is None:
            self._dev_stable = tuple(self._upload(a) for a in (
                self.tables, self.active, self.temp, self.top_k,
                self.top_p, self.seeds))
        return self._dev_stable

    def _decode_once(self) -> None:
        snapshot = [(i, s) for i, s in enumerate(self.slot_seq)
                    if self.active[i] and s is not None]
        tables, active, temp, top_k, top_p, seeds = self._dev_stable_arrays()
        all_greedy = bool((self.temp[self.active] <= 0.0).all())
        toks = self.decoder.decode(
            (self.k_pools, self.v_pools), self.carry, tables,
            self._upload(self.seq_lens), active, temp, top_k, top_p, seeds,
            all_greedy)
        self.carry = toks
        self.seq_lens[self.active] += 1
        self._ring.append(_InFlight(
            kind="decode", tokens=_Readback(toks), slots=snapshot,
            iter_idx=self._iter, t_dispatch=time.monotonic()))
        self._iter += 1

    # -- resolution / eviction ----------------------------------------------

    def _record(self, seq: Sequence, token: int, now: float) -> None:
        if seq.finished:
            return                 # lagged garbage after finish
        if not seq.out_tokens:
            seq.t_first_token = now
        seq.out_tokens.append(token)
        seq.token_times.append(now)
        if seq.on_token is not None:
            # a raising callback is disabled, not allowed to break the
            # ring resolution for every other request
            try:
                seq.on_token(token, now)
            except Exception:
                logger.exception(
                    f"on_token callback for request {seq.sid} raised; "
                    f"disabling the stream callback for this request")
                seq.on_token = None
        if seq.eos_id is not None and token == seq.eos_id:
            self._finish(seq, "eos", now)
        elif len(seq.out_tokens) >= seq.max_new:
            self._finish(seq, "length", now)

    def _finish(self, seq: Sequence, reason: str, now: float) -> None:
        seq.finished = True
        seq.finish_reason = reason
        seq.t_finish = now
        self.finished.append(seq)
        self._evict(seq)

    def _evict(self, seq: Sequence) -> None:
        slot = seq.slot
        if slot < 0:
            return
        self.slot_seq[slot] = None
        self.active[slot] = False
        self.tables[slot, :] = 0
        self.seq_lens[slot] = 0
        seq.slot = -1
        self._dev_stable = None
        # DEFERRED free: iterations dispatched before now may still
        # write through the old table
        self._deferred.append((self._iter, seq.blocks))
        seq.blocks = []
        self._release_matured()

    def _release_matured(self) -> None:
        ring_empty = not any(e.kind == "decode" for e in self._ring)
        keep = []
        for after, blocks in self._deferred:
            if self._resolved >= after or ring_empty:
                self.pool.free(blocks)
            else:
                keep.append((after, blocks))
        self._deferred = keep

    def _resolve_one(self) -> None:
        entry = self._ring.popleft()
        if self.blocked is not None:     # the (only) blocking fetch
            with self.blocked.blocked():
                toks = entry.tokens.numpy()
        else:
            toks = entry.tokens.numpy()
        now = time.monotonic()
        if entry.kind == "first":
            self._record(entry.seq, int(toks), now)
        else:
            for slot, seq in entry.slots:
                self._record(seq, int(toks[slot]), now)
            self._resolved = entry.iter_idx + 1
        self._release_matured()

    def drain(self) -> None:
        """Resolve every in-flight iteration."""
        while self._ring:
            self._resolve_one()
        self._release_matured()

    def busy(self) -> bool:
        return (any(s is not None for s in self.slot_seq)
                or bool(self._ring))
