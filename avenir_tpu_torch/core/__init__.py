from avenir_tpu_torch.core.schema import FeatureField, FeatureSchema
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.encoding import DatasetEncoder, EncodedDataset

__all__ = ["FeatureField", "FeatureSchema", "JobConfig", "DatasetEncoder", "EncodedDataset"]
