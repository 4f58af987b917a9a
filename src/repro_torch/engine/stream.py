"""StreamDecoder, DecoderBank, stream_decode: decoding arrival by arrival.

The port of `repro.engine.stream`.  The batch decoder
(:meth:`CodingEngine.decode`) needs the whole coded stack in hand; a
server hears tuples one at a time and is done the moment any K
linearly independent ones have arrived (Prop. 1).  The decoder keeps
the reduced basis of `engine.select` — ``B`` (K, K) in reduced
row-echelon form, one row per filled pivot column — and a payload
block ``Y`` (K, L) that receives the same row operations, so
B[p]·P = Y[p] for every filled pivot p.  At rank K the basis is the
identity and ``Y`` *is* the decoded packet matrix, bit-identical to the
batch decode of any full-rank subset.

**The [B | T] design.**  The reference runs `reduce_insert` on
[B | Y] inside a jitted `lax.scan`, one dispatch per `push`, per
`ingest` block and per bank tick.  Here the row space stays on the
host, as the engine's selection does, and the L-sized work runs on the
card in the hand-written packed GF kernel:

* For a block of g arrivals (a_i, c_i), let Z = [Y; c_1; …; c_g] be the
  (K + g, L) stack of the old payload block and the arrivals.  The port's
  `reduce_row`/`insert_row` run on [B | T], where T starts as
  [I_K | 0] (K, K + g) and arrival i's payload is the unit row
  e_{K+i}.  T then says which combination of Z's rows each row of the
  new Y is; GF arithmetic is linear and exact, so T·Z equals the
  reference's Y byte for byte.
* **The tripwire.**  A dependent arrival's payload residual is a row R_i
  of the same space, R_i·Z = c_i − Σ_p a_i[p]·Y[p].  Those rows go
  below T as extra output rows of the same launch and are tested for
  nonzero on the card: one small reduction and one host read a block,
  which fill ``inconsistent`` and ``first_inconsistent_at``.
* **One launch per reference dispatch.**  `push`, an `ingest` block and
  a bank tick each launch once: ``[T; R]·Z`` (K + d rows), or only the
  d tripwire rows where no arrival was independent (T is then the
  identity on Y and uses no column of the arrivals, so Y keeps its
  buffer).  A COMPLETE decoder without ``detect`` ignores a `push`, as
  the reference does.  The bank's batched tick is one launch of
  `gf_matmul_packed_batched` over all slots whatever their rows (the
  reference's one vmapped dispatch); its sequential tick launches
  `gf_matmul_packed` per slot with work whose T moves Y.
* **State.**  Z lives in one of two device buffers of K + g rows (the
  bank: (J, K + g, L) each); an arrival block is copied into rows K… of
  the current buffer, the launch writes the other, and the two swap.
  Nothing aliases.  The buffers grow when a larger block arrives (a
  decoder's first push allocates K + 1 rows, a later block of g more).
* **Seeded rows** expand on the host (`core.seeds.expand_rows`,
  bit-identical to the reference's in-scan expansion): the basis needs
  the rows anyway.  Masked columns (`col_mask`) and padding rows
  (``valid=False``) become zero coefficient rows, which are no-ops, as
  in the reference's `_bank_fns`.

``L = 0`` tracks the rank alone and launches nothing.  The rows reach
the host as they are; every payload buffer lies on ``device`` (the card
unless the caller asks for the CPU, where the kernel wrappers run their
plain versions).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.gf import get_field
from repro_torch.core.rlnc import SeededBatch
from repro_torch.core.seeds import as_seeds, expand_rows
from repro_torch.kernels.gf_matmul import (gf_matmul_packed,
                                           gf_matmul_packed_batched)

from .engine import resolve_device
from .select import insert_row, reduce_row


def _ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


def _rows_u8(x) -> torch.Tensor:
    """Coefficient rows as a host uint8 tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.uint8)
    return torch.from_numpy(np.array(x, np.uint8))


def _payload(x) -> Optional[torch.Tensor]:
    """Payload rows as a uint8 tensor where they lie (numpy: the host)."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(dtype=torch.uint8)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.uint8)))


class _BlockPlan:
    """The host half of one block: [B | T] advanced over its rows.

    `rows` (g, K) uint8 coefficient rows (zero rows are no-ops).  After
    construction: ``B``/``filled`` the new basis, ``T`` (K, K + g) the
    payload transform, ``moved`` whether any arrival was independent (T
    differs from [I | 0]), ``ranks`` (g,) the rank after each arrival,
    and — with ``tripwire`` — ``dependent`` (d,) the positions of the
    dependent arrivals and ``R`` (d, K + g) their payload residuals.
    """

    def __init__(self, field, B, filled, rows, tripwire: bool):
        K = B.shape[0]
        g = rows.shape[0]
        T = torch.zeros((K, K + g), dtype=torch.uint8)
        T[:, :K] = torch.eye(K, dtype=torch.uint8)
        self.ranks = np.zeros((g,), np.int32)
        self.moved = False
        dependent, resid = [], []
        rank = int(filled.sum())
        for i in range(g):
            a = rows[i]
            if not tripwire and not bool(a.any()):
                self.ranks[i] = rank          # a zero row changes nothing
                continue
            unit = torch.zeros((K + g,), dtype=torch.uint8)
            unit[K + i] = 1
            red_a, red_t = reduce_row(field, B, T, filled, a, unit)
            if bool(red_a.any()):
                B, T, filled = insert_row(field, B, T, filled, red_a, red_t)
                self.moved = True
                rank += 1
            elif tripwire:
                dependent.append(i)
                resid.append(red_t)
            self.ranks[i] = rank
        self.B, self.filled, self.T = B, filled, T
        self.dependent = np.asarray(dependent, np.int64)
        self.R = (torch.stack(resid) if resid
                  else torch.zeros((0, K + g), dtype=torch.uint8))


class StreamDecoder:
    """Consume coded tuples in arrival order; decode at rank K.

    ``L`` is the payload width in symbols (0 = track rank only, no
    device work).  ``device``: where the payload block lives and the
    kernel runs (the card unless asked for the CPU).

    >>> import torch
    >>> from repro_torch.core.gf import get_field
    >>> f = get_field(8)
    >>> P = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    >>> A = f.random_elements(torch.Generator().manual_seed(0), (5, 3))
    >>> C = f.matmul(A, P)
    >>> dec = StreamDecoder(K=3, L=4, s=8, device="cpu")
    >>> for g in range(5):                 # arrivals, one at a time
    ...     _ = dec.push(A[g], C[g])
    ...     if dec.complete:
    ...         break
    >>> ok, P_hat = dec.decode()
    >>> ok and torch.equal(P_hat, P), dec.decoded_at
    (True, 3)
    """

    def __init__(self, K: int, L: int = 0, s: int = 8,
                 detect: bool = False, device="cuda"):
        self.K, self.L, self.s = int(K), int(L), int(s)
        self.detect = bool(detect)
        self.field = get_field(self.s)            # host row-space work
        # a rank-only decoder never touches a device
        self.device = resolve_device(device) if self.L else torch.device(
            "cpu")
        self._B = torch.zeros((self.K, self.K), dtype=torch.uint8)
        self._filled = torch.zeros((self.K,), dtype=torch.bool)
        # two (K + g, L) payload buffers; Y is rows :K of _Z[_cur]
        self._Z: list[Optional[torch.Tensor]] = [None, None]
        self._cur = 0
        self.arrivals = 0          # tuples consumed
        self.decoded_at: Optional[int] = None   # arrival count at rank K
        self.inconsistent = 0      # provably-corrupted arrivals seen
        self.first_inconsistent_at: Optional[int] = None

    # -- state ------------------------------------------------------------

    @property
    def rank(self) -> int:
        return int(self._filled.sum())

    @property
    def complete(self) -> bool:
        return self.decoded_at is not None

    @property
    def state(self) -> str:
        return "COMPLETE" if self.complete else "FILLING"

    @property
    def tampered(self) -> bool:
        """True once any arrival proved inconsistent with the basis —
        the stream carried at least one corrupted tuple."""
        return self.inconsistent > 0

    # -- the payload block on the device ----------------------------------

    def _buffers(self, g: int) -> list[torch.Tensor]:
        """The two (K + g', L) buffers, g' >= g, Y kept in the current.
        Growing allocates the new current buffer, copies Y, frees the old
        pair and only then allocates the other: at most three buffers
        live at once."""
        rows = self.K + g
        cur = self._Z[self._cur]
        if cur is None or cur.shape[0] < rows:
            grown = torch.empty((rows, self.L), dtype=torch.uint8,
                                device=self.device)
            if cur is None:
                grown[:self.K].zero_()
            else:
                grown[:self.K].copy_(cur[:self.K])
            self._Z = [grown, None]
            self._cur = 0
            self._Z[1] = torch.empty_like(grown)
        return self._Z

    def _launch(self, plan: _BlockPlan, C) -> np.ndarray:
        """Apply one block's plan to the payload: copy the arrivals into
        the current buffer, one launch of [T; R] (or R alone), swap when
        Y moved.  Returns the (d,) tripwire flags."""
        d = plan.R.shape[0]
        g = plan.T.shape[1] - self.K
        if not self.L or not (plan.moved or d):
            return np.zeros((d,), bool)
        K = self.K
        Z = self._buffers(g)
        src, dst = Z[self._cur], Z[1 - self._cur]
        if C is None:
            src[K:K + g].zero_()
        else:
            src[K:K + g].copy_(C)
        if plan.moved:
            M = torch.cat([plan.T, plan.R]) if d else plan.T
            gf_matmul_packed(M.to(self.device), src[:K + g], s=self.s,
                             out=dst[:K + d])
            self._cur = 1 - self._cur
        else:                       # Y stays: only the tripwire rows
            gf_matmul_packed(plan.R.to(self.device), src[:K + g], s=self.s,
                             out=dst[K:K + d])
        if not d:
            return np.zeros((0,), bool)
        return dst[K:K + d].ne(0).any(dim=1).cpu().numpy()

    def _consume(self, rows: torch.Tensor, C) -> tuple[np.ndarray,
                                                       np.ndarray]:
        """One block: the host plan, then the launch.  Returns the rank
        trajectory and the (g,) tripwire flags."""
        plan = _BlockPlan(self.field, self._B, self._filled, rows,
                          tripwire=True)
        flags = self._launch(plan, C)
        self._B, self._filled = plan.B, plan.filled
        bads = np.zeros((rows.shape[0],), bool)
        bads[plan.dependent] = flags
        return plan.ranks, bads

    # -- consumption ------------------------------------------------------

    def push(self, a, c=None) -> int:
        """Consume one arrival (coding vector `a`, payload `c`).

        `a` may be a scalar *seed* (an int or a 0-D tensor) instead of a
        (K,) row — the seed-addressed wire format — in which case the row
        is regenerated here (`repro_torch.core.seeds`).  Returns the rank
        after the arrival.  Pushes after COMPLETE are counted but
        ignored unless ``detect=True``, in which case they are still
        reduced so payload-inconsistent redundancy keeps tripping the
        byzantine counter."""
        self.arrivals += 1
        if self.complete and not self.detect:
            return self.K
        if _ndim(a) == 0:
            row = expand_rows(as_seeds([int(a)]), self.K, self.s)
        else:
            row = _rows_u8(a).reshape(1, self.K)
        c = _payload(c)
        _, bads = self._consume(row, None if c is None
                                else c.reshape(1, self.L))
        if bads[0]:
            self.inconsistent += 1
            if self.first_inconsistent_at is None:
                self.first_inconsistent_at = self.arrivals
        r = self.rank
        if r == self.K and self.decoded_at is None:
            self.decoded_at = self.arrivals
        return r

    def _record_block(self, g: int, prior: int, already: bool,
                      ranks: np.ndarray, bads: np.ndarray) -> np.ndarray:
        self.arrivals += g
        if not already and ranks.size and ranks[-1] == self.K:
            self.decoded_at = prior + int(np.argmax(ranks == self.K)) + 1
        if bads.any():
            self.inconsistent += int(bads.sum())
            if self.first_inconsistent_at is None:
                self.first_inconsistent_at = prior + int(
                    np.argmax(bads)) + 1
        return ranks

    def _ingest_rows(self, rows: torch.Tensor, C_rows) -> np.ndarray:
        prior, already = self.arrivals, self.complete
        ranks, bads = self._consume(rows, _payload(C_rows))
        return self._record_block(rows.shape[0], prior, already, ranks,
                                  bads)

    def ingest(self, A_rows, C_rows=None) -> np.ndarray:
        """Consume a block of arrivals with one launch.

        A 1-D `A_rows` is a block of row *seeds* (see
        :meth:`ingest_seeded`).  Returns the (g,) rank-after-each-arrival
        trajectory; updates ``decoded_at`` with the first arrival index
        reaching K."""
        if _ndim(A_rows) == 1:
            return self.ingest_seeded(A_rows, C_rows)
        rows = _rows_u8(A_rows)
        if rows.dim() != 2 or rows.shape[1] != self.K:
            raise ValueError(f"A_rows must be (g, {self.K}), got "
                             f"{tuple(rows.shape)}")
        return self._ingest_rows(rows, C_rows)

    def ingest_seeded(self, seeds, C_rows=None,
                      col_mask=None) -> np.ndarray:
        """Consume a block of seed-addressed arrivals (one launch).

        `seeds` (g,): each row is regenerated from its 4-byte seed.
        `col_mask` (K,) bool zeroes the coefficients of absent sources
        before reduction — bit-identical to masking the materialized
        rows."""
        rows = expand_rows(as_seeds(seeds).cpu(), self.K, self.s)
        if col_mask is not None:
            rows[:, ~torch.as_tensor(np.asarray(col_mask, bool))] = 0
        return self._ingest_rows(rows, C_rows)

    # -- the result -------------------------------------------------------

    def _Y(self) -> torch.Tensor:
        if self._Z[self._cur] is None:
            return torch.zeros((self.K, self.L), dtype=torch.uint8,
                               device=self.device)
        return self._Z[self._cur][:self.K]

    def decode(self) -> tuple[bool, Optional[torch.Tensor]]:
        """(ok, P_hat).  At rank K the basis is the identity, so the
        payload block is already the decoded packet matrix (a view of
        the decoder's buffer on its device; no later arrival changes
        it, since every arrival after rank K is dependent)."""
        if not self.complete:
            return False, None
        return True, self._Y()

    def basis(self) -> torch.Tensor:
        """The current reduced basis, on the host (diagnostics / tests)."""
        return self._B.clone()


class DecoderBank:
    """J :class:`StreamDecoder` states advanced one tick at a time.

    The serving layer (`repro_torch.serve`) holds many federated rounds
    in flight; each *slot* is one job's reduced-basis state [B | Y].  All
    slots share the bank-wide padded shape (``K`` coefficient columns,
    ``L`` payload symbols): a job with a smaller generation size ``k``
    masks the columns beyond ``k``, a shorter payload zero-pads, and GF
    row operations never mix columns, so padding stays zero.

    A tick (:meth:`ingest`) takes a padded (slots, g) block of arrivals
    for every slot: the host plans [B | T] per slot, then the payloads
    move with ONE launch of `gf_matmul_packed_batched` over all slots
    (``batched=True``) or one `gf_matmul_packed` launch per slot with
    work (``batched=False``, the sequential baseline).  Both are
    bit-identical; ``dispatches`` counts as the reference's does.

    >>> import torch
    >>> bank = DecoderBank(slots=2, K=2, L=4, device="cpu")
    >>> bank.open(0, k=2), bank.open(1, k=2)
    (0, 1)
    >>> P = torch.arange(8, dtype=torch.uint8).reshape(2, 4)
    >>> eye = torch.eye(2, dtype=torch.uint8)
    >>> ranks = bank.ingest(rows=torch.stack([eye, eye]),
    ...                     C=torch.stack([P, P ^ 1]))
    >>> ranks.tolist()                     # both jobs, one launch
    [[1, 2], [1, 2]]
    >>> bank.complete.tolist()
    [True, True]
    >>> torch.equal(bank.payload(1), P ^ 1)
    True
    """

    def __init__(self, slots: int, K: int, L: int, s: int = 8,
                 device="cuda"):
        self.slots, self.K, self.L, self.s = (int(slots), int(K),
                                              int(L), int(s))
        self.field = get_field(self.s)
        self.device = resolve_device(device) if self.L else torch.device(
            "cpu")
        J = self.slots
        self._B = torch.zeros((J, self.K, self.K), dtype=torch.uint8)
        self._filled = torch.zeros((J, self.K), dtype=torch.bool)
        self._col_mask = np.zeros((J, self.K), bool)
        self._k = np.zeros((J,), np.int64)   # 0 = slot closed
        self._l = np.zeros((J,), np.int64)
        self._Z: Optional[torch.Tensor] = None   # (2, J, K + g, L)
        self._cur = np.zeros((J,), np.int64)     # buffer holding slot j's Y
        self.dispatches = 0

    # -- slot lifecycle ---------------------------------------------------

    def open(self, slot: int, k: int, l: Optional[int] = None,
             col_mask=None) -> int:
        """(Re)initialize `slot` for a job with generation size `k`.

        `col_mask` (k,) bool masks dropped sources; columns beyond `k`
        are always masked.  Returns the slot index."""
        slot = int(slot)
        if not 0 < k <= self.K:
            raise ValueError(f"job k={k} exceeds bank K={self.K}")
        l = self.L if l is None else int(l)
        if l > self.L:
            raise ValueError(f"job L={l} exceeds bank L={self.L}")
        self._B[slot] = 0
        self._filled[slot] = False
        if self._Z is not None:
            self._Z[self._cur[slot], slot, :self.K].zero_()
        mask = np.zeros((self.K,), bool)
        mask[:k] = True if col_mask is None else np.asarray(col_mask,
                                                            bool)[:k]
        self._col_mask[slot] = mask
        self._k[slot] = k
        self._l[slot] = l
        return slot

    def close(self, slot: int) -> None:
        """Retire a slot (its state stays until the next `open`)."""
        self._k[int(slot)] = 0

    @property
    def open_slots(self) -> np.ndarray:
        return np.nonzero(self._k > 0)[0]

    @property
    def target(self) -> np.ndarray:
        """(slots,) per-job target rank (0 for closed slots)."""
        return self._k.copy()

    @property
    def rank(self) -> np.ndarray:
        return self._filled.sum(dim=1).numpy()

    @property
    def complete(self) -> np.ndarray:
        """(slots,) — open slots whose basis reached their target rank."""
        return (self._k > 0) & (self.rank >= self._k)

    # -- the tick ---------------------------------------------------------

    def _tick_rows(self, rows, seeds, use_seed, valid, C):
        """The tick's (J, g, K) coefficient rows after format selection
        and masking, its `valid` mask and payloads."""
        g = None
        for arr in (rows, seeds, C):
            if arr is not None:
                g = int(np.shape(arr)[1])
                break
        if g is None:
            raise ValueError("need rows, seeds, or C to size the tick")
        J, K = self.slots, self.K
        rows = (torch.zeros((J, g, K), dtype=torch.uint8) if rows is None
                else _rows_u8(rows))
        if use_seed is not None:
            use = torch.as_tensor(np.asarray(use_seed, bool))
            seeds = np.zeros((J, g), np.int64) if seeds is None else seeds
            gen = expand_rows(as_seeds(seeds).reshape(-1), K,
                              self.s).reshape(J, g, K)
            rows = torch.where(use[..., None], gen, rows)
        valid = (np.ones((J, g), bool) if valid is None
                 else np.asarray(valid, bool))
        keep = torch.as_tensor(self._col_mask[:, None, :] & valid[..., None])
        return torch.where(keep, rows, torch.zeros_like(rows)), valid, C

    def _buffers(self, g: int) -> torch.Tensor:
        rows = self.K + g
        if self._Z is None:
            self._Z = torch.zeros((2, self.slots, rows, self.L),
                                  dtype=torch.uint8, device=self.device)
            self._cur[:] = 0
        elif self._Z.shape[2] < rows:
            grown = torch.empty((2, self.slots, rows, self.L),
                                dtype=torch.uint8, device=self.device)
            for j in range(self.slots):
                grown[0, j, :self.K].copy_(self._Z[self._cur[j], j, :self.K])
            self._Z = grown
            self._cur[:] = 0
        return self._Z

    def ingest(self, rows=None, seeds=None, use_seed=None, valid=None,
               C=None, *, batched: bool = True) -> np.ndarray:
        """Advance every slot by one padded (slots, g) tick block.

        `rows` (slots, g, K) uint8 materialized coding rows, `seeds`
        (slots, g) row seeds, `use_seed` (slots, g) bool format selector
        per tuple, `valid` (slots, g) bool padding mask, `C` (slots, g, L)
        uint8 payloads (numpy or a tensor on any device); omitted arrays
        default to zeros (and `valid` to all-true).  Returns the
        (slots, g) rank-after-each-arrival trajectory.

        ``batched=True`` moves every slot's payload with ONE launch of
        `gf_matmul_packed_batched` (one dispatch); ``batched=False``
        launches `gf_matmul_packed` once per slot holding work (one
        dispatch each) — the sequential per-job baseline.  Both are
        bit-identical.
        """
        a, valid, C = self._tick_rows(rows, seeds, use_seed, valid, C)
        J, g = valid.shape
        work = valid.any(axis=1)
        plans: list[Optional[_BlockPlan]] = [None] * J
        ranks = np.repeat(self.rank[:, None], g, axis=1).astype(np.int32)
        for j in range(J):
            if batched or work[j]:
                plans[j] = _BlockPlan(self.field, self._B[j],
                                      self._filled[j], a[j], tripwire=False)
                ranks[j] = plans[j].ranks
        C = _payload(C)
        if batched:
            self.dispatches += 1
            if self.L:
                self._launch_batched(plans, C, g)
        else:
            for j in np.nonzero(work)[0]:
                self.dispatches += 1
                if self.L and plans[j].moved:
                    self._launch_slot(int(j), plans[j], C, g)
        for j, plan in enumerate(plans):
            if plan is not None:
                self._B[j] = plan.B
                self._filled[j] = plan.filled
        return ranks

    def _launch_batched(self, plans, C, g: int) -> None:
        """All slots in one launch: align the slots on one buffer, copy
        the tick's payloads into its rows K…, launch into the other."""
        Z = self._buffers(g)
        K = self.K
        cur = int(np.bincount(self._cur, minlength=2).argmax())
        for j in np.nonzero(self._cur != cur)[0]:   # mixed-mode leftovers
            Z[cur, j, :K].copy_(Z[1 - cur, j, :K])
        self._cur[:] = cur
        src, dst = Z[cur], Z[1 - cur]
        if C is None:
            src[:, K:K + g].zero_()
        else:
            src[:, K:K + g].copy_(C)
        T = torch.stack([p.T for p in plans]).to(self.device)
        gf_matmul_packed_batched(T, src[:, :K + g], s=self.s,
                                 out=dst[:, :K])
        self._cur[:] = 1 - cur

    def _launch_slot(self, j: int, plan: _BlockPlan, C, g: int) -> None:
        Z = self._buffers(g)
        K = self.K
        c = int(self._cur[j])
        src, dst = Z[c, j], Z[1 - c, j]
        if C is None:
            src[K:K + g].zero_()
        else:
            src[K:K + g].copy_(C[j])
        gf_matmul_packed(plan.T.to(self.device), src[:K + g], s=self.s,
                         out=dst[:K])
        self._cur[j] = 1 - c

    # -- results ----------------------------------------------------------

    @property
    def state_buffers(self) -> Optional[torch.Tensor]:
        """The device buffers holding every slot's payload state (None
        before the first launch): fence on them to wait for a tick."""
        return self._Z

    def payload(self, slot: int) -> torch.Tensor:
        """The decoded (k, l) packet matrix of a complete slot, a copy on
        the bank's device.

        At rank k the basis restricted to the job's columns is the
        identity, so rows [0, k) of Y are the decoded packets."""
        slot = int(slot)
        k, l = int(self._k[slot]), int(self._l[slot])
        if self._Z is None:
            return torch.zeros((k, l), dtype=torch.uint8, device=self.device)
        return self._Z[self._cur[slot], slot, :k, :l].clone()

    def basis(self, slot: int) -> torch.Tensor:
        return self._B[int(slot)].clone()


def stream_decode(batch, s: int, order=None, device="cuda"
                  ) -> tuple[bool, Optional[torch.Tensor], int]:
    """Decode an EncodedBatch (or SeededBatch) row by row in arrival order.

    `order` permutes the rows (default: transmission order).  Returns
    ``(ok, P_hat, consumed)`` where `consumed` is the number of
    arrivals the server needed — the rank-K prefix length (`decoded_at`;
    n when rank K was never reached).  The whole batch is one `ingest`
    block, one launch: arrivals past the rank-K prefix reduce to zero
    against the completed basis.  A SeededBatch's rows are regenerated
    from its seeds.  The batch's payloads must lie on `device`.
    """
    K = batch.K
    rows = batch.seeds if isinstance(batch, SeededBatch) else batch.A
    C = batch.C
    dec = StreamDecoder(K=K, L=C.shape[1], s=s, device=device)
    if C.device.type != dec.device.type:
        raise ValueError(f"the payloads are on {C.device}, the decoder on "
                         f"{dec.device}")
    if order is not None:
        idx = torch.as_tensor(np.asarray(order), dtype=torch.int64)
        rows = rows[idx.to(rows.device)]
        C = C[idx.to(C.device)]
    dec.ingest(rows, C)
    ok, P_hat = dec.decode()
    return bool(ok), P_hat, (dec.decoded_at if dec.complete
                             else dec.arrivals)
