"""PAF limb scoring and greedy person assembly on the host (the JAX
package's `decode/paf_np.py`, the exact decode):

- every (src, dst) peak pair of each limb is scored by the mean dot
  product of the upsampled PAF at 10 points along it, with a distance
  penalty;
- pairs where more than 80% of the samples exceed thresh_paf and the
  penalized mean is positive are kept and assigned one to one greedily by
  descending score;
- the limb assignments are merged into persons, and persons with fewer than
  3 parts or a mean score under 0.2 dropped.

The PAF stack is upsampled as cv2's INTER_CUBIC does (`peaks_np.resize_cubic`,
bit for bit: a stack of more than 4 channels never goes to IPP).
"""

from __future__ import annotations

import numpy as np

from popnet_tpu_torch.core.skeleton import LIMBS, NUM_JOINTS
from popnet_tpu_torch.decode.peaks_np import nms_heatmaps, resize_cubic


def find_connected_joints(
    paf_upsamp: np.ndarray,
    joint_list_per_joint_type,
    num_intermed_pts: int = 10,
    thresh_paf: float = 0.05,
    limbs=LIMBS,
):
    """Greedy per-limb connection candidates.

    Returns a list of per-limb (n, 5) arrays
    [src_peak_id, dst_peak_id, score, src_index, dst_index].
    """
    connected_limbs = []
    coords = np.empty((4, num_intermed_pts), dtype=np.intp)
    for limb_type, (src_type, dst_type) in enumerate(limbs):
        joints_src = joint_list_per_joint_type[src_type]
        joints_dst = joint_list_per_joint_type[dst_type]
        if len(joints_src) == 0 or len(joints_dst) == 0:
            connected_limbs.append([])
            continue

        candidates = []
        coords[2, :] = 2 * limb_type
        coords[3, :] = 2 * limb_type + 1
        for i, joint_src in enumerate(joints_src):
            for j, joint_dst in enumerate(joints_dst):
                limb_dir = joint_dst[:2] - joint_src[:2]
                limb_dist = np.sqrt(np.sum(limb_dir**2)) + 1e-8
                limb_dir = limb_dir / limb_dist

                coords[1, :] = np.round(
                    np.linspace(joint_src[0], joint_dst[0], num=num_intermed_pts)
                )
                coords[0, :] = np.round(
                    np.linspace(joint_src[1], joint_dst[1], num=num_intermed_pts)
                )
                intermed_paf = paf_upsamp[coords[0, :], coords[1, :], coords[2:4, :]].T
                score_pts = intermed_paf.dot(limb_dir)
                score_penalized = score_pts.mean() + min(
                    0.5 * paf_upsamp.shape[0] / limb_dist - 1, 0
                )
                crit1 = np.count_nonzero(score_pts > thresh_paf) > 0.8 * num_intermed_pts
                crit2 = score_penalized > 0
                if crit1 and crit2:
                    candidates.append(
                        [i, j, score_penalized, score_penalized + joint_src[2] + joint_dst[2]]
                    )

        candidates = sorted(candidates, key=lambda x: x[2], reverse=True)
        connections = np.empty((0, 5))
        max_connections = min(len(joints_src), len(joints_dst))
        for cand in candidates:
            i, j, s = cand[0:3]
            if i not in connections[:, 3] and j not in connections[:, 4]:
                connections = np.vstack(
                    [connections, [joints_src[i][3], joints_dst[j][3], s, i, j]]
                )
                if len(connections) >= max_connections:
                    break
        connected_limbs.append(connections)
    return connected_limbs


def group_limbs_of_same_person(connected_limbs, joint_list, num_joints: int = NUM_JOINTS,
                               limbs=LIMBS, min_parts: int = 3, min_score: float = 0.2):
    """Union-merge limb connections into person rows.

    Returns (n_people, num_joints + 2): peak ids per joint (-1 = missing),
    then [total score, joint count].
    """
    person_to_joint_assoc = []
    for limb_type, (src_type, dst_type) in enumerate(limbs):
        for limb_info in connected_limbs[limb_type]:
            assoc_idx = []
            for person, person_limbs in enumerate(person_to_joint_assoc):
                if person_limbs[src_type] == limb_info[0] or person_limbs[dst_type] == limb_info[1]:
                    assoc_idx.append(person)

            if len(assoc_idx) == 1:
                person_limbs = person_to_joint_assoc[assoc_idx[0]]
                if person_limbs[dst_type] != limb_info[1]:
                    person_limbs[dst_type] = limb_info[1]
                    person_limbs[-1] += 1
                    person_limbs[-2] += joint_list[limb_info[1].astype(int), 2] + limb_info[2]
            elif len(assoc_idx) == 2:
                p1 = person_to_joint_assoc[assoc_idx[0]]
                p2 = person_to_joint_assoc[assoc_idx[1]]
                membership = ((p1 >= 0) & (p2 >= 0))[:-2]
                if not membership.any():
                    p1[:-2] += p2[:-2] + 1
                    p1[-2:] += p2[-2:]
                    p1[-2] += limb_info[2]
                    person_to_joint_assoc.pop(assoc_idx[1])
                else:
                    p1[dst_type] = limb_info[1]
                    p1[-1] += 1
                    p1[-2] += joint_list[limb_info[1].astype(int), 2] + limb_info[2]
            else:
                row = -1 * np.ones(num_joints + 2)
                row[src_type] = limb_info[0]
                row[dst_type] = limb_info[1]
                row[-1] = 2
                row[-2] = sum(joint_list[limb_info[:2].astype(int), 2]) + limb_info[2]
                person_to_joint_assoc.append(row)

    keep = [
        p for p in person_to_joint_assoc
        if p[-1] >= min_parts and p[-2] / p[-1] >= min_score
    ]
    return np.array(keep)


def paf_to_pose(
    heatmaps: np.ndarray,
    pafs: np.ndarray,
    downsample: int = 8,
    thresh_heatmap: float = 0.1,
    thresh_paf: float = 0.05,
    num_intermed_pts: int = 10,
    num_joints: int = NUM_JOINTS,
    limbs=LIMBS,
):
    """The whole bottom-up decode: (H, W, K) heatmaps and (H, W, 2L) PAFs
    -> (joint_list, person rows)."""
    joint_list_per_joint_type = nms_heatmaps(
        heatmaps, upsamp_factor=downsample, thresh=thresh_heatmap, num_joints=num_joints
    )
    joint_list = np.array(
        [
            tuple(peak) + (joint_type,)
            for joint_type, peaks in enumerate(joint_list_per_joint_type)
            for peak in peaks
        ]
    )
    paf_upsamp = resize_cubic(pafs, downsample)
    connected_limbs = find_connected_joints(
        paf_upsamp, joint_list_per_joint_type, num_intermed_pts, thresh_paf, limbs
    )
    person_to_joint_assoc = group_limbs_of_same_person(
        connected_limbs, joint_list, num_joints, limbs
    )
    return joint_list, person_to_joint_assoc
