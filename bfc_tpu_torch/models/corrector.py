"""Batched correction on the card (kernels KC and KD) and result assembly.

Counterpart of bfc_tpu/models/corrector.py: a batch of encoded reads goes
to the card once, KC annotates it and KD corrects every read in its own
thread; the host turns the packed result into ASCII rows and the
reference's packed stat words, and re-corrects the reads that overflowed
KD's fixed scratch with the scalar model (refmodel.ec1), whose output is
the same bytes (correct.c:388-472).  The lockstep scheduling of the TPU
version (soft caps, resume pools, difficulty buckets, shape buckets) has
no counterpart: each read's thread simply runs to its end.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..opts import Opts
from ..ops import annotate as ann
from ..ops import search as srch
from ..ops.spectrum import IntProbe
from . import refmodel as M
from .counter import DeviceSpectrum


@dataclasses.dataclass
class BatchResult:
    """Per-batch results: final ASCII rows + packed stats.

    seq_rows/qual_rows are uint8 [n, L] matrices holding the output text
    (sliced by lens); aux/aux2 are the reference's packed stat words
    (correct.c:552-553); code is the ec_code (aux & 7).  Reads in
    `exceptional` (KD overflows re-run on the scalar model) carry their
    full (EcStat, seq, qual) tuple instead."""

    n: int
    lens: np.ndarray
    seq_rows: np.ndarray
    qual_rows: np.ndarray
    aux: np.ndarray
    aux2: np.ndarray
    code: np.ndarray
    has_q: np.ndarray
    text_of: object
    exceptional: dict

    def tuple_of(self, i: int):
        """Per-read view: (EcStat, seq, qual)."""
        if i in self.exceptional:
            return self.exceptional[i]
        code = int(self.code[i])
        brute = int(self.aux[i] >> np.uint64(3)) & 1
        if code != 0:
            s_in, q_in = self.text_of(i)
            return (M.EcStat(ec_code=code, brute=brute), s_in, q_in)
        a, a2 = int(self.aux[i]), int(self.aux2[i])
        st = M.EcStat(
            ec_code=0, brute=brute,
            n_ec=(a >> 18) & 0x3FFF, n_ec_high=(a >> 4) & 0x3FFF,
            n_absent=a2 >> 10, rf_code=0, max_heap=a2 & 0xFF,
        )
        ln = int(self.lens[i])
        s2 = self.seq_rows[i, :ln].tobytes().decode("ascii")
        q2 = (self.qual_rows[i, :ln].tobytes().decode("ascii")
              if self.has_q[i] else None)
        return (st, s2, q2)


def assemble(packed: np.ndarray, out: np.ndarray):
    """KD's packed bases and stat columns -> (seq_rows, qual_rows, aux,
    aux2, code), packed exactly as worker_ec does (correct.c:451-459,
    552-553); a failed read keeps only brute | code."""
    U = np.uint64
    fb = packed & 7
    isd = (packed & 8) != 0
    seq_rows = np.where(isd, np.frombuffer(b"acgtn", np.uint8)[fb],
                        np.frombuffer(b"ACGTN", np.uint8)[fb])
    qual_rows = np.where(
        isd, 34 + (packed >> 5),
        np.frombuffer(b"+?", np.uint8)[((packed >> 4) & 1).astype(np.int32)])
    code = out[:, srch.EC_CODE].astype(np.int64)
    ok = code == 0
    brute = (out[:, srch.BRUTE].astype(U) & U(1)) << U(3)
    aux_ok = (((out[:, srch.N_EC].astype(U) & U(0x3FFF)) << U(18))
              | ((out[:, srch.N_EC_HIGH].astype(U) & U(0x3FFF)) << U(4)))
    aux = np.where(ok, aux_ok, U(0)) | brute | (code.astype(U) & U(7))
    aux2_ok = ((out[:, srch.N_ABSENT].astype(U) << U(10))
               | (out[:, srch.MAX_HEAP].astype(U) & U(0xFF)))
    aux2 = np.where(ok, aux2_ok, U(0))
    return seq_rows, qual_rows, aux, aux2, code


class Corrector:
    def __init__(self, opt: Opts, ds: DeviceSpectrum,
                 heap_cap: int = srch.HEAP_CAP, stack_cap: int = srch.STACK_CAP):
        self.opt = opt
        self.ds = ds
        self.caps = (heap_cap, stack_cap)
        self.device = ds.table.table.device
        self.n_fallback = 0
        self.t_device = 0.0  # host seconds in device_step (KC + KD + copies)
        # host copy of the table for the scalar fallback, made at the
        # first overflow
        self._probe: Optional[IntProbe] = None

    def device_step(self, bases0: np.ndarray, rawq0: np.ndarray,
                    lens0: np.ndarray, has_q: np.ndarray):
        """KC + KD on one batch.  bases0 u8 [n, >= max len] codes, rawq0
        the raw quality ASCII (0 where absent).  Returns the host copies
        of KD's (packed [n, L], out [n, 7])."""
        t0 = time.time()
        opt = self.opt
        n = len(lens0)
        L = max(int(lens0.max()) if n else 1, 1)
        bases = np.ascontiguousarray(bases0[:, :L])
        inb = np.arange(L)[None, :] < lens0[:, None]
        qv = rawq0[:, :L].astype(np.int32) - 33
        qflag = np.where(has_q[:, None], qv >= opt.q, inb) & (bases <= 3)
        dev = self.device
        b_t = torch.from_numpy(bases).to(dev)
        q_t = torch.from_numpy(qflag).to(dev)
        l_t = torch.from_numpy(np.ascontiguousarray(lens0, np.int32)).to(dev)
        t = self.ds.table
        _, lcov, hcov, isl = ann.kcov_island(t, b_t, l_t, opt.min_cov)
        packed, out = srch.ec1_search(t, opt, self.ds.mode, b_t, q_t, l_t,
                                      lcov, hcov, isl, *self.caps)
        packed, out = packed.cpu().numpy(), out.cpu().numpy()
        self.t_device += time.time() - t0
        return packed, out

    def correct_arrays(self, bases0, rawq0, lens0, has_q,
                       text_of) -> BatchResult:
        """Correct one batch; text_of(i) -> (seq, qual) gives the original
        text of read i, needed only for the scalar fallback."""
        n = len(lens0)
        packed, out = self.device_step(bases0, rawq0, lens0, has_q)
        seq_rows, qual_rows, aux, aux2, code = assemble(packed, out)
        exceptional = {}
        for i in np.nonzero(out[:, srch.OVERFLOW])[0]:
            if self._probe is None:
                self._probe = IntProbe(self.ds.table)
            s_in, q_in = text_of(int(i))
            exceptional[int(i)] = M.ec1(self.opt, self._probe, self.ds.mode,
                                        s_in, q_in)
        self.n_fallback += len(exceptional)
        return BatchResult(
            n=n, lens=np.asarray(lens0), seq_rows=seq_rows,
            qual_rows=qual_rows, aux=aux, aux2=aux2, code=code,
            has_q=np.asarray(has_q), text_of=text_of,
            exceptional=exceptional,
        )
