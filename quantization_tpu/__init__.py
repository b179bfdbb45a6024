"""quantization_tpu — a vector quantization engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of qdrant/quantization:
compress float32 embedding corpora into scalar-u8, product-quantization, or
binary codes, and score query batches against them on device, preserving the
reference's "bigger score = better unless ``invert``" contract — batched,
jittable, and shardable over device meshes.
"""

from .core.types import (
    ArgumentsError,
    DistanceType,
    EncodingError,
    QuantizationError,
    StoppedError,
    StorageIOError,
    VectorParameters,
)
from .core.distances import distance, pairwise, pairwise_score, score
from .core.interface import EncodedVectors, validate_vector_parameters
from .core.storage import EncodedStorage, EncodedStorageBuilder
from .models.bq import BinaryQuantizer, EncodedQueryBin, EncodedVectorsBin
from .models.ivf import IVFIndex, auto_geometry
from .models.pipeline import ExactRescorer, TwoStageIndex
from .models.pq import EncodedQueryPQ, EncodedVectorsPQ, ProductQuantizer
from .models.sq import EncodedQueryU8, EncodedVectorsU8, ScalarQuantizerU8
from .policy import ServingPlan, exact_topk, recall_at_k, recommend
from .serving import PipelinedSearcher

__all__ = [
    "ArgumentsError",
    "BinaryQuantizer",
    "DistanceType",
    "EncodedQueryBin",
    "EncodedQueryPQ",
    "EncodedQueryU8",
    "EncodedStorage",
    "EncodedStorageBuilder",
    "EncodedVectors",
    "EncodedVectorsBin",
    "EncodedVectorsPQ",
    "EncodedVectorsU8",
    "EncodingError",
    "ExactRescorer",
    "IVFIndex",
    "PipelinedSearcher",
    "ProductQuantizer",
    "QuantizationError",
    "ScalarQuantizerU8",
    "ServingPlan",
    "StoppedError",
    "StorageIOError",
    "TwoStageIndex",
    "VectorParameters",
    "auto_geometry",
    "distance",
    "exact_topk",
    "pairwise",
    "pairwise_score",
    "recall_at_k",
    "recommend",
    "score",
    "validate_vector_parameters",
]

__version__ = "0.1.0"
