"""Cluster identity of a process (port of the part of
``alink_tpu.parallel.distributed`` that standalone worker spawners need:
``CLUSTER_ENV_KEYS`` and :func:`scrub_cluster_env`).

The reference's multi-host initialisation (``init_multi_host``, the global
meshes) moves onto ``torch.distributed`` with ROADMAP A3.
"""

from __future__ import annotations

#: Topology knobs by which a launcher hands a process its place in a
#: training cluster: the reference's three (read by its ``init_multi_host``)
#: and those of a ``torch.distributed`` launcher (``torchrun`` and its
#: elastic agent). A process spawned for a *different* purpose (a
#: serving-fleet replica, a helper subprocess) must not inherit them — it
#: would try to join the training cluster instead of coming up standalone.
#: ``CUDA_VISIBLE_DEVICES`` is not among them: a replica must see the card.
CLUSTER_ENV_KEYS = (
    "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
    "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
    "LOCAL_WORLD_SIZE", "GROUP_RANK", "GROUP_WORLD_SIZE", "ROLE_RANK",
    "ROLE_WORLD_SIZE", "ROLE_NAME",
)
_CLUSTER_ENV_PREFIXES = ("TORCHELASTIC_",)


def scrub_cluster_env(env: dict) -> dict:
    """Return a copy of *env* with the multi-host topology knobs removed.

    Used by spawners of standalone worker processes (``serving/fleet.py``)
    so a fleet launched from inside a training pod does not hand its
    replicas the pod's cluster identity."""
    return {k: v for k, v in env.items()
            if k not in CLUSTER_ENV_KEYS
            and not k.startswith(_CLUSTER_ENV_PREFIXES)}
