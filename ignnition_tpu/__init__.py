"""ignnition_tpu — a declarative GNN framework in JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
IGNNITION framework (reference: zhangbiqiong/ignnition): declarative
model_description.json -> compiled message-passing GNN, with a padded
statically-shaped merged GraphBatch, `lax.scan` message-passing iterations,
a Pallas (Triton) kernel for dense GAT attention, and shard_map
parallelism.

Public API mirrors the reference's four verbs (framework_operations.py):
`create_model`, `train_and_evaluate`, `predict`, `debug` — plus the lower
layers (frontend/data/model/training) for programmatic use.
"""

from .frontend import (
    ModelDescriptionError,
    load_description,
    parse_model_description,
    parse_model_file,
)
from .frontend import ir
from .data import (
    BatchMeta,
    PaddingConfig,
    SampleSpec,
    build_batch,
    convert_sample,
    find_dataset_dimensions,
    iter_samples,
)
from .model import GnnModel, build
from .nn.layers import register_layer
from .utils import get_normalization, register_normalization

__version__ = "0.1.0"

__all__ = [
    "ModelDescriptionError",
    "load_description",
    "parse_model_description",
    "parse_model_file",
    "ir",
    "BatchMeta",
    "PaddingConfig",
    "SampleSpec",
    "build_batch",
    "convert_sample",
    "find_dataset_dimensions",
    "iter_samples",
    "GnnModel",
    "build",
    "get_normalization",
    "register_layer",
    "register_normalization",
    "__version__",
]


def __getattr__(name):
    # API verbs live in .api, which pulls in training deps (optax);
    # import lazily so light-weight uses stay light.
    if name in ("create_model", "train_and_evaluate", "predict", "debug",
                "Runner", "Model", "RunConfig"):
        from . import api

        return getattr(api, name)
    if name in ("export_serving", "load_serving", "ServingModel"):
        from . import serving

        return getattr(serving, name)
    raise AttributeError(name)
