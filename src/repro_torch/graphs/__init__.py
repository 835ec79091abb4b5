"""The paper's evaluation workloads as GEMM-sequence Tasks (Sec. 7):
AlexNet, ViT, Vision Mamba, HydraNet. The port's copies of the JAX
package's ``graphs/``, built from their layer shapes on the port's
``core.workload``."""
from .alexnet import alexnet_task  # noqa: F401
from .hydranet import hydranet_task  # noqa: F401
from .vision_mamba import vision_mamba_task  # noqa: F401
from .vit import vit_task  # noqa: F401

WORKLOADS = {
    "alexnet": alexnet_task,
    "vit": vit_task,
    "vision_mamba": vision_mamba_task,
    "hydranet": hydranet_task,
}
