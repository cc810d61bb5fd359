from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointCorruptionError,
    CheckpointManager,
    flatten_tree,
    leaf_digest,
)
