"""The pipeline schedule over every stage in one process (a helper,
never collected): the CPU tests hold the package's schedule against the
JAX package's pipelines with it, and ``chip_smoke.py`` runs it on the
card against the unpipelined step.

``virtual_pipeline`` is a ``parallel.pp.Pipeline`` of all ``pp_size``
stages whose transport hands each tick's messages from one stage's
outbox to the next one's inbox, in the tick's message order: the
package's own tick tables, stage runners and chunk calls, with only the
process group emulated.  ``StaleTransport`` is a control: it hands one
stage the activation of the micro-batch before the one it asked for
(the first gets its own), so a schedule that routed wrongly would read
like it.
"""

from torchacc_tpu_torch.parallel.pp import Pipeline


class VirtualTransport:
    """Moves each message from its source stage's outbox to its
    destination stage's inbox (``like``, the receive buffers' tensor
    over a process group, has no use here)."""

    def exchange(self, messages, stages, like=None):
        for kind, src, dst, m, c_src, c_dst in messages:
            stages[dst].inbox[(kind, m, c_dst)] = self.deliver(
                kind, dst, m, stages[src].outbox.pop((kind, m, c_src)))

    def deliver(self, kind, dst, m, tensor):
        return tensor


class StaleTransport(VirtualTransport):
    """Hands stage ``stage`` the activation that arrived before this one
    (the first arrival its own): a control that must break the loss."""

    def __init__(self, stage: int):
        self.stage, self.prev = stage, None

    def deliver(self, kind, dst, m, tensor):
        if kind != "F" or dst != self.stage:
            return tensor
        out = tensor if self.prev is None else self.prev
        self.prev = tensor
        return out


def virtual_pipeline(pp_size: int, num_micro: int, schedule: str = "gpipe",
                     virtual: int = 1, transport=None) -> Pipeline:
    """Every stage of a ``pp_size``-stage pipeline in this process."""
    return Pipeline(pp_size, num_micro, schedule, virtual,
                    stages=range(pp_size),
                    transport=transport or VirtualTransport())
