from glnn_tpu_torch.sampling.sampler import (
    WINDOW1_EXACT_DEG,
    WINDOW_EXACT_DEG,
    SampledBlocks,
    frontier_caps,
    sample_blocks,
    sample_one_hop,
)

__all__ = ["SampledBlocks", "frontier_caps", "sample_blocks", "sample_one_hop",
           "WINDOW_EXACT_DEG", "WINDOW1_EXACT_DEG"]
