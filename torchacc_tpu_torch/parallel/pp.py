"""Pipeline parallelism (the port of torchacc_tpu/parallel/pp.py): the
GPipe schedule (``pipeline_blocks`` :140), the 1F1B schedule
(``pipeline_train_1f1b`` :396, ``pipeline_loss_1f1b`` :917) and the
interleaved form of both (``virtual_stages`` V > 1).

The JAX package runs the pipeline as one SPMD program: the layer stack
sharded over 'pp', micro-batches circulating by ``ppermute`` inside a
``lax.scan`` over ticks, the backward by autodiff (GPipe) or by hand in
a custom-VJP region (1F1B).  Autograd does not cross processes, so the
port runs the same tick tables imperatively, one process a stage:

- :func:`gpipe_ticks` and :func:`one_f_one_b_ticks` are the tables:
  for every tick and stage, which ('F' | 'B', micro, chunk) actions run,
  from JAX's own tick formulas.  GPipe's forward puts micro m's chunk c
  on stage d at tick ``c * period + d + m`` (``period`` = M when V > 1
  and M >= P, else P: the two regimes of :140's docstring), and its
  backward mirrors the forward ticks, as the transpose of the scan runs
  them.  1F1B's is the Megatron group order of :421-470 (V = 1: F of
  micro ``t - d``, B of micro ``t - 2(P-1) + d``).
- :class:`Stage` is one stage's runner: its banked inputs (1F1B keeps
  each chunk's input and re-runs the chunk under autograd in the B
  tick, so stage d holds at most ``min(2(P-1-d)+1, M)`` micro-batches
  at once; GPipe keeps each chunk's graph until its B tick) and the
  tensors it sends and receives.  The last virtual stage runs its
  chunk, the head and the loss under autograd in the F tick and
  back-propagates the loss at once: its B action that tick is that
  backward (JAX re-runs the chunk under ``jax.vjp`` in the same tick
  instead; the same math, one forward fewer).
- :class:`Pipeline` runs the ticks over the stages this process holds
  (one on a mesh; all of them in ``tests/torch_pp_virtual.py``, which
  drives the schedule on one device) and hands each tick's messages to
  a transport: :class:`ProcessGroupTransport` posts every send and
  receive of a tick in one ``batch_isend_irecv``, in the same order on
  every rank, activations to the next stage and cotangents to the
  previous one.  Only the activation travels: every stage of one data
  shard has the step's rows, so each reads its micro-batch's positions,
  segment ids and labels itself (JAX's riders).  On more than one data
  shard those rows are the rank's share of JAX's micro-batches, which
  cut the global batch (``Trainer._jax_rows``), so that micro-batch m's
  dropout coordinates and mixture-of-experts routing are JAX's.  A failed send or
  receive raises; there is no fallback.

The schedule computes the gradients of the loss *sum* times ``scale``
(:meth:`Pipeline.run`; 1, or the fp16 loss scale), which the head's
backward takes as its cotangent, and the Trainer divides by the global
token count.  This is the port's form of ``pipeline_loss_1f1b``
(:917-960), whose custom VJP scales the schedule's gradients by the
loss cotangent after the region: the Trainer knows that cotangent
before the schedule runs, and its accumulation hooks take each
gradient off ``.grad`` as it lands, so it is applied at the head.  What calls a chunk is the caller's ``call(d,
c, m, x, last)``: stage d's chunk c on micro-batch m from the input
``x`` (None for the first virtual stage, which embeds its tokens), and
with ``last`` the head and the loss, ``(loss_sum, count)``
(``models.transformer.pp_forward_sum_count``).  Another chunk may
return ``(output, extra)``, ``extra`` a scalar loss term of its own (a
mixture of experts' weighted router losses): it joins the stage's loss
sum, and its gradient (times ``scale``) the chunk's backward.

Not ported (no meaning here): ``micro_split_spec``, ``_micro_splitter``
and ``_micro_merger`` (:66-114) are GSPMD layout hints, and
``_boundary_needs_f32`` (:42) an XLA:CPU workaround whose f32 round trip
of a bf16 activation is exact.

The pipelined decode (:func:`pp_forward_with_cache`, JAX :963) runs one
micro-batch over the virtual stages in order: each stage runs its chunk
with the KV cache of its own blocks, which never leaves it, hands the
activation to the next stage (one message a hop, through the same
transport), and the last stage's output goes to every stage (JAX's
``psum`` over 'pp'), so that every stage samples the same token.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# ('F' | 'B', micro, chunk)
Action = Tuple[str, int, int]
# (kind, source stage, destination stage, micro, source chunk,
# destination chunk)
Message = Tuple[str, int, int, int, int, int]


def _check(pp_size: int, num_micro: int, virtual: int, schedule: str) -> None:
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"pp.schedule must be gpipe|1f1b, got {schedule}")
    if pp_size < 1 or num_micro < 1 or virtual < 1:
        raise ValueError(f"pp size {pp_size}, micro-batches {num_micro} and "
                         f"virtual stages {virtual} must be >= 1")
    if schedule == "1f1b" and virtual > 1 and num_micro % pp_size:
        raise ValueError(
            f"interleaved 1f1b requires num_micro_batches ({num_micro}) "
            f"divisible by pp size ({pp_size}) — the Megatron group "
            "schedule runs micro groups of P through the V chunks")


def gpipe_ticks(pp_size: int, num_micro: int, virtual: int = 1,
                train: bool = True) -> List[List[List[Action]]]:
    """``table[t][d]``: the actions of stage d at tick t under GPipe
    (``pipeline_blocks`` :204-244): micro m's chunk c forward at tick
    ``c * period + d + m`` over ``T = (V-1) * period + P - 1 + M``
    ticks, then (``train``) its backward at tick ``2T - 1`` minus that."""
    P, M, V = pp_size, num_micro, virtual
    _check(P, M, V, "gpipe")
    period = M if V > 1 and M >= P else P
    T = (V - 1) * period + P - 1 + M
    table: List[List[List[Action]]] = [[[] for _ in range(P)]
                                       for _ in range(2 * T if train else T)]
    for m in range(M):
        for c in range(V):
            for d in range(P):
                t = c * period + d + m
                table[t][d].append(("F", m, c))
                if train:
                    table[2 * T - 1 - t][d].append(("B", m, c))
    return table


def one_f_one_b_ticks(pp_size: int, num_micro: int,
                      virtual: int = 1) -> List[List[List[Action]]]:
    """``table[t][d]``: the actions of stage d at tick t under 1F1B
    (``pipeline_train_1f1b`` :651-668), F before B in a tick, over
    ``T = V*M + V*P + P - 2`` ticks.  With ``u = t - d``, micro
    ``m = (u // VP) * P + u % VP % P`` runs chunk ``u % VP // P``
    forward; with ``u = t - (VP - 1) - (P - 1 - d)`` the same
    decomposition, the chunk order reversed, runs backward."""
    P, M, V = pp_size, num_micro, virtual
    _check(P, M, V, "1f1b")
    VP = V * P
    T = V * M + VP + P - 2
    table: List[List[List[Action]]] = [[[] for _ in range(P)]
                                       for _ in range(T)]
    for t in range(T):
        for d in range(P):
            u = t - d
            if 0 <= u < V * M:
                g, rem = divmod(u, VP)
                table[t][d].append(("F", g * P + rem % P, rem // P))
            u = t - (VP - 1) - (P - 1 - d)
            if 0 <= u < V * M:
                g, rem = divmod(u, VP)
                table[t][d].append(("B", g * P + rem % P,
                                    V - 1 - rem // P))
    return table


def tick_table(schedule: str, pp_size: int, num_micro: int,
               virtual: int = 1, train: bool = True
               ) -> List[List[List[Action]]]:
    """The table of ``schedule``; evaluation (``train`` false) runs
    GPipe's forward ticks under either."""
    if schedule == "1f1b" and train:
        return one_f_one_b_ticks(pp_size, num_micro, virtual)
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"pp.schedule must be gpipe|1f1b, got {schedule}")
    return gpipe_ticks(pp_size, num_micro, virtual, train)


def tick_messages(actions: Sequence[Sequence[Action]], pp_size: int,
                  virtual: int = 1) -> List[Message]:
    """The messages of one tick, ``actions[d]`` being stage d's, in one
    order every rank computes alike: an F of virtual stage ``s = c*P +
    d`` sends its activation to stage s + 1 (the next rank; the first
    rank's next chunk after the last rank), a B sends its input's
    cotangent to stage s - 1.  The first virtual stage's cotangent
    goes into the embedding and the last's output into the head, so
    neither travels."""
    P, V = pp_size, virtual
    out: List[Message] = []
    for d in range(P):
        for kind, m, c in actions[d]:
            s = c * P + d
            if kind == "F" and s < V * P - 1:
                out.append(("F", d, (d + 1) % P, m, c, c + (d + 1) // P))
            elif kind == "B" and s > 0:
                out.append(("B", d, (d - 1) % P, m, c,
                            c - (1 if d == 0 else 0)))
    return out


def stage_layers(num_layers: int, pp_size: int, virtual: int,
                 stage: int) -> List[range]:
    """The layers of each chunk of ``stage``: chunk c is virtual stage
    ``c * P + stage``, whose layers are the ``L / (P*V)`` after it
    (JAX's ``[V, P, L/(V*P)]`` staging, :211-217)."""
    per = _per_chunk(num_layers, pp_size, virtual)
    return [range((c * pp_size + stage) * per,
                  (c * pp_size + stage + 1) * per) for c in range(virtual)]


def _per_chunk(num_layers: int, pp_size: int, virtual: int) -> int:
    if num_layers % (pp_size * virtual):
        raise ValueError(f"num_layers {num_layers} not divisible by pp "
                         f"size {pp_size} x virtual_stages {virtual}")
    return num_layers // (pp_size * virtual)


def _leaf(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.detach().requires_grad_(True)


def _split(out) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A chunk's ``(output, extra loss term or None)``."""
    return out if isinstance(out, tuple) else (out, None)


class Stage:
    """One stage's runner for one schedule run: ``act`` runs an action,
    reading its input from ``inbox`` and putting what it sends in
    ``outbox`` (both keyed by ``(kind, micro, chunk)``); ``l_sum`` and
    ``count`` add up the losses of the micro-batches whose head ran
    here; ``max_live`` is the most micro-batches it held at once."""

    def __init__(self, index: int, pp_size: int, virtual: int,
                 schedule: str, call: Callable, train: bool,
                 scale: Optional[torch.Tensor]):
        self.index, self.P, self.V = index, pp_size, virtual
        self.schedule, self.call, self.train = schedule, call, train
        self.scale = scale
        self.inbox: Dict[Tuple[str, int, int], torch.Tensor] = {}
        self.outbox: Dict[Tuple[str, int, int], torch.Tensor] = {}
        # 1F1B: (m, c) -> the chunk's input (None where it embeds);
        # GPipe: (m, c) -> (the input leaf, the output or the loss sum)
        self.bank: Dict[Tuple[int, int], Any] = {}
        # 1F1B: the (m, c) whose backward ran in their F tick
        self.fused: set = set()
        self.max_live = 0
        self.l_sum: Optional[torch.Tensor] = None
        self.count: Optional[torch.Tensor] = None

    def act(self, kind: str, m: int, c: int) -> None:
        s = c * self.P + self.index
        last = s == self.V * self.P - 1
        if kind == "F":
            self._forward(m, c, s, last)
        else:
            self._backward(m, c, s, last)
        self.max_live = max(self.max_live, len(self.bank) + len(self.fused))

    def _add_loss(self, l_sum: torch.Tensor,
                  count: Optional[torch.Tensor] = None) -> None:
        l_sum = l_sum.detach().float()
        self.l_sum = l_sum if self.l_sum is None else self.l_sum + l_sum
        if count is not None:
            count = count.detach().float()
            self.count = (count if self.count is None
                          else self.count + count)

    def _output(self, out):
        """A non-last chunk's output, its extra loss term added to the
        stage's loss sum."""
        y, extra = _split(out)
        if extra is not None:
            self._add_loss(extra)
        return y, extra

    def _chunk_backward(self, y: torch.Tensor, extra, g: torch.Tensor
                        ) -> None:
        if extra is None:
            torch.autograd.backward(y, g)
            return
        torch.autograd.backward(
            (y, extra if self.scale is None else extra * self.scale),
            (g, None))

    def _head_backward(self, l_sum: torch.Tensor) -> None:
        torch.autograd.backward(
            l_sum if self.scale is None else l_sum * self.scale)

    def _send_grad(self, m: int, c: int, s: int, x) -> None:
        if s > 0:
            if x.grad is None:
                raise RuntimeError(
                    f"pipeline stage {self.index}: chunk {c} of micro-batch "
                    f"{m} left its input without a gradient")
            self.outbox[("B", m, c)] = x.grad

    def _forward(self, m: int, c: int, s: int, last: bool) -> None:
        x = None if s == 0 else self.inbox.pop(("F", m, c))
        if not self.train:
            with torch.no_grad():
                out = self.call(self.index, c, m, x, last)
            if last:
                self._add_loss(*out)
            else:
                self.outbox[("F", m, c)] = self._output(out)[0]
            return
        if self.schedule == "gpipe":
            xg = _leaf(x)
            with torch.enable_grad():
                out = self.call(self.index, c, m, xg, last)
            if last:
                self._add_loss(*out)
                self.bank[(m, c)] = (xg, out[0], None)
            else:
                y, extra = self._output(out)
                self.bank[(m, c)] = (xg, y, extra)
                self.outbox[("F", m, c)] = y.detach()
            return
        if last:
            # the head's cotangent is ready at once: chunk, head, loss and
            # their backward in this tick (the tick's B action of (m, c))
            xg = _leaf(x)
            with torch.enable_grad():
                l_sum, count = self.call(self.index, c, m, xg, True)
                self._head_backward(l_sum)
            self._add_loss(l_sum, count)
            self.fused.add((m, c))
            if s > 0:
                self._send_grad(m, c, s, xg)
            return
        with torch.no_grad():
            y = self._output(self.call(self.index, c, m, x, False))[0]
        self.bank[(m, c)] = x
        self.outbox[("F", m, c)] = y

    def _backward(self, m: int, c: int, s: int, last: bool) -> None:
        if self.schedule == "1f1b":
            if (m, c) in self.fused:
                self.fused.discard((m, c))
                return
            xg = _leaf(self.bank.pop((m, c)))
            with torch.enable_grad():
                # the re-run's extra term was counted in the F tick
                y, extra = _split(self.call(self.index, c, m, xg, False))
                self._chunk_backward(y, extra, self.inbox.pop(("B", m, c)))
            self._send_grad(m, c, s, xg)
            return
        xg, out, extra = self.bank.pop((m, c))
        if last:
            self._head_backward(out)
        else:
            self._chunk_backward(out, extra, self.inbox.pop(("B", m, c)))
        self._send_grad(m, c, s, xg)


class ProcessGroupTransport:
    """The messages of a tick between this rank and its pipeline
    neighbours: ``ranks[d]`` is the global rank of stage d
    (``parallel.mesh.pp_ranks``, a ring), ``like`` a tensor of the shape,
    dtype and device of every activation and cotangent (a micro-batch's
    ``[rows, seq, hidden]`` in the compute dtype).  One
    ``batch_isend_irecv`` a tick, its sends and receives posted in the
    tick's message order, which every rank computes alike; the gloo
    tags keep an activation and a cotangent between the same two ranks
    apart."""

    def __init__(self, ranks: Sequence[int], stage: int,
                 like: torch.Tensor, group=None):
        self.ranks, self.stage, self.like = list(ranks), stage, like
        # the 'pp' process group of these ranks (the decode's broadcast)
        self.group = group

    def warm(self) -> None:
        """One exchange in which every stage sends to both neighbours and
        receives from both: NCCL makes its P2P communicators at the
        first send, and a batch that not every rank of the group joins
        must not be that first one."""
        n = len(self.ranks)
        prev = self.ranks[(self.stage - 1) % n]
        nxt = self.ranks[(self.stage + 1) % n]
        bufs = [torch.zeros(1, device=self.like.device) for _ in range(4)]
        ops = [dist.P2POp(dist.isend, bufs[0], nxt, tag=0),
               dist.P2POp(dist.isend, bufs[1], prev, tag=1),
               dist.P2POp(dist.irecv, bufs[2], prev, tag=0),
               dist.P2POp(dist.irecv, bufs[3], nxt, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def exchange(self, messages: Sequence[Message],
                 stages: Dict[int, Stage],
                 like: Optional[torch.Tensor] = None) -> None:
        """Post this rank's sends and receives of ``messages``; each
        receive lands in a buffer like ``like`` (default the
        transport's own)."""
        me = stages[self.stage]
        like = self.like if like is None else like
        ops, received = [], []
        for kind, src, dst, m, c_src, c_dst in messages:
            tag = 0 if kind == "F" else 1
            if src == self.stage:
                t = me.outbox.pop((kind, m, c_src)).contiguous()
                ops.append(dist.P2POp(dist.isend, t, self.ranks[dst],
                                      tag=tag))
            if dst == self.stage:
                buf = torch.empty_like(like)
                ops.append(dist.P2POp(dist.irecv, buf, self.ranks[src],
                                      tag=tag))
                received.append(((kind, m, c_dst), buf))
        if not ops:
            return
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for key, buf in received:
            me.inbox[key] = buf

    def share_last(self, y: Optional[torch.Tensor],
                   like: torch.Tensor) -> torch.Tensor:
        """The last stage's ``y`` on every stage: one broadcast over the
        'pp' group (``like`` gives the other stages' buffer)."""
        last = len(self.ranks) - 1
        buf = (y.contiguous() if self.stage == last
               else torch.empty_like(like))
        dist.broadcast(buf, src=self.ranks[last], group=self.group)
        return buf


class _Hop:
    """A decode stage's mailboxes, keyed as :class:`Stage`'s are."""

    def __init__(self):
        self.inbox: Dict[Tuple[str, int, int], torch.Tensor] = {}
        self.outbox: Dict[Tuple[str, int, int], torch.Tensor] = {}


def pp_forward_with_cache(chunk: Callable, pipeline: "Pipeline",
                          like: torch.Tensor) -> torch.Tensor:
    """One pass of a decode's micro-batch over ``pipeline``'s virtual
    stages (JAX's ``pp_forward_with_cache`` :963): virtual stage ``s =
    c * P + d`` is stage d's chunk c, run in the order s = 0, 1, ..., so
    the layers run in their order, stage d running the blocks it holds
    (with ``virtual`` chunks a stage, the activation laps the ring V
    times).  ``chunk(d, c, x)`` runs stage d's chunk c on ``x`` (None
    for the first virtual stage, which embeds its tokens) against the
    cache of those blocks, which stays with the stage.  Each hop is one
    message of ``like``'s shape and dtype ``[b, t, hidden]`` through the
    pipeline's transport (``exchange(messages, stages, like)``); the
    last stage's output is returned on every stage, shared by the
    transport's ``share_last`` where the stages are in other
    processes."""
    P, V = pipeline.pp_size, pipeline.virtual
    hops = {d: _Hop() for d in pipeline.stages}
    transport = pipeline.transport
    y = None
    for s in range(V * P):
        d, c = s % P, s // P
        actions = [[("F", 0, c)] if e == d else [] for e in range(P)]
        if d in hops:
            x = None if s == 0 else hops[d].inbox.pop(("F", 0, c))
            y = chunk(d, c, x)
            hops[d].outbox[("F", 0, c)] = y
        messages = tick_messages(actions, P, V)
        if messages:
            transport.exchange(messages, hops, like)
    if len(hops) == P:
        return y
    return transport.share_last(y if P - 1 in hops else None, like)


def decode_pipeline(mesh, virtual: int, device) -> Optional["Pipeline"]:
    """The pipeline a decode runs over on ``mesh`` (the trainer's, on
    which the model was sharded): this rank's stage of the 'pp' axis,
    ``virtual`` chunks a stage (the model config's ``pp_virtual``), over
    a process-group transport, as ``Trainer._pipeline_for`` builds it;
    None where the mesh has no 'pp' axis above 1.  Pass it to
    ``generate(..., pipeline=)``."""
    from torchacc_tpu_torch.parallel.mesh import pp_ranks, pp_stage
    n_pp, stage = pp_stage(mesh)
    if n_pp == 1:
        return None
    # each pass hands ``exchange`` and ``share_last`` its activation's
    # shape; this one only places ``warm``'s buffers
    transport = ProcessGroupTransport(
        pp_ranks(mesh), stage, torch.empty(0, device=device),
        group=mesh.get_group("pp"))
    transport.warm()
    return Pipeline(n_pp, 1, "gpipe", virtual, stages=[stage],
                    transport=transport)


class Pipeline:
    """One schedule over the stages ``stages`` of a ``pp_size``-stage
    pipeline (``virtual`` chunks a stage, ``num_micro`` micro-batches a
    run) and a transport with ``exchange(messages, stages)``."""

    def __init__(self, pp_size: int, num_micro: int, schedule: str = "gpipe",
                 virtual: int = 1, stages: Optional[Sequence[int]] = None,
                 transport: Any = None):
        _check(pp_size, num_micro, virtual, schedule)
        self.pp_size, self.num_micro = pp_size, num_micro
        self.schedule, self.virtual = schedule, virtual
        self.stages = list(range(pp_size) if stages is None else stages)
        self.transport = transport
        # the stages of the last run (their max_live, for the residual
        # bound)
        self.last_run: Dict[int, Stage] = {}

    def run(self, call: Callable, train: bool = True,
            scale: Optional[torch.Tensor] = None):
        """``(loss_sum, count)`` summed over the micro-batches whose head
        ran on this process's stages (zeros where none did: sum them over
        'pp'), the gradients of ``loss_sum * scale`` (``scale`` None: 1)
        accumulated into the parameters' ``.grad`` (``train``)."""
        P, V = self.pp_size, self.virtual
        stages = {d: Stage(d, P, V, self.schedule, call, train, scale)
                  for d in self.stages}
        for actions in tick_table(self.schedule, P, self.num_micro, V,
                                  train):
            for d, stage in stages.items():
                for kind, m, c in actions[d]:
                    stage.act(kind, m, c)
            messages = tick_messages(actions, P, V)
            if messages:
                self.transport.exchange(messages, stages)
        self.last_run = stages
        l_sum = [s.l_sum for s in stages.values() if s.l_sum is not None]
        count = [s.count for s in stages.values() if s.count is not None]
        return sum(l_sum), sum(count)
