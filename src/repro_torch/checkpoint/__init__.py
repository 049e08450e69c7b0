from repro_torch.checkpoint.manager import (  # noqa: F401 (re-exported API)
    COMMIT_NAME,
    FORMAT_VERSION,
    CheckpointCorruptError,
    CheckpointError,
    CheckpointManager,
    CheckpointShapeError,
    CheckpointVersionError,
)
