from repro_torch.kernels.gather_scatter.ops import (EdgeCSR,  # noqa: F401
                                                    gather_scatter)
from repro_torch.kernels.gather_scatter.ref import (  # noqa: F401
    gather_scatter_ref)
