"""Greedy person assembly on the device, vectorized over the batch.

The JAX package runs this as two XLA scans (popnet_tpu/decode/
assemble_device.py); here the scans are Python loops over tensor ops, on
every device:

1. per limb, M rounds of masked argmax over the (M, M) pair scores, each
   killing the picked row and column — the reference's stable sort by
   descending score with the first-flat-index tie rule;
2. a sequential union-merge over the L*M connections (limb-major) into a
   (L*M, K) slot table, in creation order;
3. keep slots that are alive with count >= min_parts and an f32 mean score
   >= min_score, packed in creation order into (max_people, K) ids.

On the card that is about 240 steps of small launches, so it is bound by
launch latency, not by the card; the K6 kernel of the TPU package
(assemble_ids_pallas) is its candidate replacement.
"""

from __future__ import annotations

import torch

from popnet_tpu_torch.core.skeleton import LIMBS


def assemble_batched(peaks: torch.Tensor, peak_valid: torch.Tensor,
                     scores: torch.Tensor, ok: torch.Tensor, limbs: tuple = LIMBS,
                     max_people: int = 16, min_parts: int = 3,
                     min_score: float = 0.2):
    """peaks (B, K, M, 3), peak_valid (B, K, M), scores and ok (B, L, M, M)
    -> (joints (B, max_people, K, 3), counts (B,) int32). Holes are
    (-1, -1, 0)."""
    B, K, M, _ = peaks.shape
    L = len(limbs)
    P = L * M
    dev = peaks.device
    peaks = peaks.float()
    ninf = torch.tensor(float("-inf"), device=dev)

    # ---- stage 1: per-limb greedy 1-1 matching, descending score ----------
    s = torch.where(ok, scores.float(), ninf).reshape(B, L, M * M)
    ar = torch.arange(M, device=dev)
    ci, cj, cv = [], [], []
    for _ in range(M):
        idx = s.argmax(dim=-1)                                   # (B, L), first max
        val = s.gather(-1, idx[..., None])[..., 0]
        i, j = idx // M, idx % M
        kill = (i[..., None, None] == ar[:, None]) | (j[..., None, None] == ar[None, :])
        s = torch.where(kill.reshape(B, L, M * M), ninf, s)
        ci.append(i)
        cj.append(j)
        cv.append(val)
    ci = torch.stack(ci, -1).reshape(B, P)          # limb-major, pick order within
    cj = torch.stack(cj, -1).reshape(B, P)
    cv = torch.stack(cv, -1).reshape(B, P)
    cgood = torch.isfinite(cv)
    cv = torch.where(cgood, cv, 0.0)

    # ---- stage 2: sequential union-merge over connections -----------------
    peak_score = peaks[..., 2]                                   # (B, K, M)
    bar = torch.arange(B, device=dev)
    slot = torch.arange(P, device=dev)
    ids = torch.full((B, P, K), -1, dtype=torch.int32, device=dev)
    score = torch.zeros((B, P), dtype=torch.float32, device=dev)
    count = torch.zeros((B, P), dtype=torch.int32, device=dev)
    alive = torch.zeros((B, P), dtype=torch.bool, device=dev)
    ncre = torch.zeros((B,), dtype=torch.int64, device=dev)
    for n in range(P):
        src_t, dst_t = limbs[n // M]
        i = ci[:, n].to(torch.int32)
        j = cj[:, n].to(torch.int32)
        cs, good = cv[:, n], cgood[:, n]

        match = alive & ((ids[:, :, src_t] == i[:, None]) | (ids[:, :, dst_t] == j[:, None]))
        a0 = match.to(torch.int8).argmax(dim=1)                  # first match, or 0
        oh0 = slot == a0[:, None]
        has0 = match.any(dim=1)
        m2 = match & ~oh0
        a1 = m2.to(torch.int8).argmax(dim=1)
        oh1 = slot == a1[:, None]
        has1 = m2.any(dim=1)

        src_sc = peak_score[bar, src_t, i.long()]
        dst_sc = peak_score[bar, dst_t, j.long()]
        row0 = ids[bar, a0]                                      # (B, K)
        row1 = ids[bar, a1]
        sc0, sc1 = score[bar, a0], score[bar, a1]
        ct0, ct1 = count[bar, a0], count[bar, a1]

        already = row0[:, dst_t] == j
        overlap = ((row0 >= 0) & (row1 >= 0)).any(dim=1)
        case_new = good & ~has0
        case_two = good & has1
        case_setdst = (good & has0 & ~has1 & ~already) | (case_two & overlap)
        case_merge = case_two & ~overlap
        do_write = case_new | case_setdst | case_merge

        row_setdst = row0.clone()
        row_setdst[:, dst_t] = j
        row_new = torch.full_like(row0, -1)
        row_new[:, src_t] = i
        row_new[:, dst_t] = j
        new_row = torch.where(case_new[:, None], row_new,
                              torch.where(case_merge[:, None], row0 + row1 + 1, row_setdst))
        new_sc = torch.where(case_new, src_sc + dst_sc + cs,
                             torch.where(case_merge, sc0 + sc1 + cs, sc0 + dst_sc + cs))
        new_ct = torch.where(case_new, 2, torch.where(case_merge, ct0 + ct1, ct0 + 1))

        p_tgt = torch.where(case_new, ncre, a0)
        wmask = (slot == p_tgt[:, None]) & do_write[:, None]     # (B, P)
        ids = torch.where(wmask[:, :, None], new_row[:, None, :], ids)
        score = torch.where(wmask, new_sc[:, None], score)
        count = torch.where(wmask, new_ct.to(torch.int32)[:, None], count)
        alive = (alive | wmask) & ~(oh1 & case_merge[:, None])
        ncre = ncre + case_new.long()

    # ---- stage 3: filter + emit in creation order --------------------------
    # f32 division, as the native assembler's `score / count < min_score`
    mean_sc = score / count.clamp(min=1).float()
    survive = alive & (count >= min_parts) & (mean_sc >= min_score)
    rank = survive.long().cumsum(dim=1) - 1
    keep = survive & (rank < max_people)
    counts = survive.sum(dim=1).clamp(max=max_people).to(torch.int32)
    out_slot = torch.where(keep, rank, max_people)               # dump slot
    out_ids = torch.full((B, max_people + 1, K), -1, dtype=torch.int32, device=dev)
    out_ids.scatter_(1, out_slot[:, :, None].expand(B, P, K),
                     torch.where(keep[:, :, None], ids, -1))
    return _emit_joints(peaks, out_ids[:, :max_people], counts)


def _emit_joints(peaks: torch.Tensor, out_ids: torch.Tensor, counts: torch.Tensor):
    """Packed peak-id table -> (joints (B, Pout, K, 3), counts)."""
    B, K, M, _ = peaks.shape
    idx = out_ids.long().clamp(0, M - 1)                         # (B, Pout, K)
    g = peaks[torch.arange(B, device=peaks.device)[:, None, None],
              torch.arange(K, device=peaks.device)[None, None, :], idx]
    hole = torch.tensor([-1.0, -1.0, 0.0], device=peaks.device)
    return torch.where(out_ids[..., None] >= 0, g, hole), counts
