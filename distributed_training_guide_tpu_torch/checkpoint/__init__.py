"""Checkpoints of the port: the JAX package's ``checkpoint`` contract
(state.json resume trigger, manifests, retention chain, fallback,
precision and mesh stamps), stored with ``torch.distributed.checkpoint``."""
from .manifest import (load_manifest, manifest_path, verify_manifest,
                       write_manifest)
from .orbax_io import (CheckpointCorruptionError, CheckpointIO,
                       abstract_train_state, restore_train_state,
                       stamp_host_state)
from .reshard import (ReshardIncompatibleError, check_reshard_compatibility,
                      describe_layout, mesh_descriptor)

__all__ = [
    "CheckpointIO",
    "CheckpointCorruptionError",
    "abstract_train_state",
    "restore_train_state",
    "stamp_host_state",
    "ReshardIncompatibleError",
    "check_reshard_compatibility",
    "describe_layout",
    "mesh_descriptor",
    "write_manifest",
    "load_manifest",
    "verify_manifest",
    "manifest_path",
]
