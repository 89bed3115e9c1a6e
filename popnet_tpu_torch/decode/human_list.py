"""Assembled person rows -> the benchmark's human-list contract."""

from __future__ import annotations

import numpy as np


def paf_to_human_list(joint_list, person_to_joint_assoc):
    """Person rows of `paf_np.paf_to_pose` -> (humans, each K x [x, y] with
    [-1, -1] where a joint is missing; visibility; confidences)."""
    humans, visibility, conf_vec = [], [], []
    for human in person_to_joint_assoc:
        joint_indices = human[:-2].astype(np.int64)
        joints, conf = [], []
        for ind in joint_indices:
            if ind < 0:
                joints.append([-1, -1])
                conf.append(0)
            else:
                joints.append(joint_list[ind, :2].tolist())
                conf.append(float(joint_list[ind, 2]))
        humans.append(joints)
        visibility.append((joint_indices >= 0).astype(np.int64).tolist())
        conf_vec.append(conf)
    return humans, visibility, conf_vec
