"""Greedy person assembly from device-scored limb candidates (host side).

The port's own copy of `popnet_tpu/decode/assemble.py`, kept equal to it
(tests/test_torch_eval.py pins the two).

Consumes the fixed-size outputs of decode/device.py and runs the reference's
greedy 1-1 limb assignment + union-merge (reference: paf_to_pose.py:234-351)
on the tiny candidate lists, on the host: the assembly of the Open-Pose+
evaluation's host path (`cli/evaluate.py`, `device_decode=False`).

Returns, per image, (humans, visibility, conf) in the benchmark's
human-list contract (coordinates in upsampled-image pixels).
"""

from __future__ import annotations

import numpy as np

from popnet_tpu_torch.core.skeleton import LIMBS, NUM_JOINTS


def assemble_image(peaks, peak_valid, scores, ok, limbs=LIMBS,
                   num_joints: int = NUM_JOINTS, min_parts: int = 3,
                   min_score: float = 0.2):
    """peaks (K, M, 3), peak_valid (K, M), scores (L, M, M), ok (L, M, M)."""
    n_peaks = peak_valid.sum(axis=1)  # (K,)

    # person rows reference (joint_type, peak_slot); scores need peak scores
    person_rows = []  # each: (ids array (K,), total score, count)

    for limb_type, (src_t, dst_t) in enumerate(limbs):
        ns, nd = int(n_peaks[src_t]), int(n_peaks[dst_t])
        if ns == 0 or nd == 0:
            continue
        cand = []
        sc = scores[limb_type]
        okl = ok[limb_type]
        for i in range(ns):
            for j in range(nd):
                if okl[i, j]:
                    cand.append((i, j, float(sc[i, j])))
        cand.sort(key=lambda t: t[2], reverse=True)

        connections = []  # (src_slot, dst_slot, score)
        used_i, used_j = set(), set()
        max_conn = min(ns, nd)
        for i, j, s in cand:
            if i not in used_i and j not in used_j:
                connections.append((i, j, s))
                used_i.add(i)
                used_j.add(j)
                if len(connections) >= max_conn:
                    break

        for i, j, s in connections:
            src_id = (src_t, i)
            dst_id = (dst_t, j)
            assoc = [
                p for p, row in enumerate(person_rows)
                if row[0][src_t] == i or row[0][dst_t] == j
            ]
            src_score = float(peaks[src_t, i, 2])
            dst_score = float(peaks[dst_t, j, 2])
            if len(assoc) == 1:
                row = person_rows[assoc[0]]
                if row[0][dst_t] != j:
                    row[0][dst_t] = j
                    row[2] += 1
                    row[1] += dst_score + s
            elif len(assoc) == 2:
                r1 = person_rows[assoc[0]]
                r2 = person_rows[assoc[1]]
                overlap = np.any((r1[0] >= 0) & (r2[0] >= 0))
                if not overlap:
                    r1[0][:] = r1[0] + r2[0] + 1
                    r1[1] += r2[1] + s
                    r1[2] += r2[2]
                    person_rows.pop(assoc[1])
                else:
                    r1[0][dst_t] = j
                    r1[2] += 1
                    r1[1] += dst_score + s
            else:
                ids = -np.ones(num_joints, dtype=np.int64)
                ids[src_t] = i
                ids[dst_t] = j
                person_rows.append([ids, src_score + dst_score + s, 2])

    humans, visibility, conf = [], [], []
    for ids, total, count in person_rows:
        if count < min_parts or total / count < min_score:
            continue
        joints, cf = [], []
        for k in range(num_joints):
            if ids[k] < 0:
                joints.append([-1.0, -1.0])
                cf.append(0.0)
            else:
                joints.append([float(peaks[k, ids[k], 0]), float(peaks[k, ids[k], 1])])
                cf.append(float(peaks[k, ids[k], 2]))
        humans.append(joints)
        visibility.append([int(i >= 0) for i in ids])
        conf.append(cf)
    return humans, visibility, conf


def assemble_batch(peaks, peak_valid, scores, ok, **kw):
    """Vectorized inputs (B, ...) -> per-image human lists."""
    peaks = np.asarray(peaks)
    peak_valid = np.asarray(peak_valid)
    scores = np.asarray(scores)
    ok = np.asarray(ok)
    out = []
    for b in range(peaks.shape[0]):
        out.append(assemble_image(peaks[b], peak_valid[b], scores[b], ok[b], **kw))
    return out
