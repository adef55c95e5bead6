from repro_torch.kernels.topk_merge.ops import merge_topk_dev
from repro_torch.kernels.topk_merge.ref import merge_topk_ref

__all__ = ["merge_topk_dev", "merge_topk_ref"]
