"""The paper's motivating pathology-image application, implemented in PyTorch."""

from repro_torch.app.pipeline import (  # noqa: F401
    TABLE1_SPACE,
    build_segmentation_stage,
    build_workflow,
    run_adaptive_study,
    run_dataset_study,
    run_study,
    synthetic_tile,
)
