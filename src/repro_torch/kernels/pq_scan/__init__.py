from repro_torch.kernels.pq_scan.ops import pq_adc_topk
from repro_torch.kernels.pq_scan.ref import pq_adc_topk_ref, pq_scores_ref

__all__ = ["pq_adc_topk", "pq_adc_topk_ref", "pq_scores_ref"]
