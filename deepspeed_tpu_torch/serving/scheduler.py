"""SplitFuse token-budget scheduling policy.

Generalizes the selection logic that ``RaggedScheduler.next_batch`` /
``engine_v2._run_fused_chunk`` hard-coded into a policy object the
frontend installs on the engine's scheduler (``scheduler.policy = ...``).
Each engine step packs a fixed token budget mixing single-token decodes of
running sequences with prefill chunks of newly admitted ones (Dynamic
SplitFuse, arXiv:2401.08671): decode rows ride every step (bounded TPOT)
while leftover budget drains prefill FIFO (bounded, starvation-free TTFT).

Copy of ``deepspeed_tpu/serving/scheduler.py`` (pure Python).
"""

from typing import List, Tuple


class TokenBudgetPolicy:
    """select() contract: ``(state, budget, prefill_chunk) →
    [(uid, take), ...]`` over ``state.seqs``.

    Decode rows (pending == 1) are packed first, rotated round-robin so a
    budget smaller than the decode population still serves every row
    within a bounded number of steps. Remaining budget goes to prefill
    (pending > 1) in arrival order — strict FIFO means the oldest prefill
    always drains first, so no request waits forever behind a stream of
    later arrivals (starvation-freedom; tested in test_serving.py).
    """

    def __init__(self, decode_priority: bool = True):
        self.decode_priority = decode_priority
        self._arrival: dict = {}
        self._next_arrival = 0
        self._rr = 0                 # decode round-robin offset

    def decode_backlog(self, state) -> Tuple[int, int]:
        """``(decode_rows, prefill_rows)`` over the live selectable
        sequences — the frontend's megastep K policy keys off this view
        of the NEXT selection: any prefill row means the coming batch is
        mixed (megastep inapplicable, K=1), while a pure decode backlog's
        depth scales how many tokens one device window may run. Counts
        every engine sequence, not just frontend-owned ones, because
        ``select`` packs from the same population."""
        dec = pre = 0
        for seq in state.seqs.values():
            if seq.done or seq.pending == 0:
                continue
            if seq.pending == 1:
                dec += 1
            else:
                pre += 1
        return dec, pre

    def note_arrival(self, uid: int) -> None:
        """Frontend stamps admission order (uid values may be arbitrary)."""
        if uid not in self._arrival:
            self._arrival[uid] = self._next_arrival
            self._next_arrival += 1

    def forget(self, uid: int) -> None:
        self._arrival.pop(uid, None)

    def select(self, state, budget: int,
               prefill_chunk: int) -> List[Tuple[int, int]]:
        decodes: List[int] = []
        prefills: List[int] = []
        for uid, seq in state.seqs.items():
            if seq.done or seq.pending == 0:
                continue
            (decodes if seq.pending == 1 else prefills).append(uid)
        order = sorted(decodes, key=lambda u: self._arrival.get(u, u))
        if self.decode_priority and order:
            off = self._rr % len(order)
            order = order[off:] + order[:off]
        picks: List[Tuple[int, int]] = []
        for uid in order:
            if budget < 1:
                # advance the rotation by how many decodes were actually
                # packed, so the rows cut off this step lead the next one
                self._rr += len(picks)
                return picks
            picks.append((uid, 1))
            budget -= 1
        for uid in sorted(prefills, key=lambda u: self._arrival.get(u, u)):
            if budget < 1:
                break
            take = min(state.seqs[uid].pending, prefill_chunk, budget)
            picks.append((uid, take))
            budget -= take
        return picks
