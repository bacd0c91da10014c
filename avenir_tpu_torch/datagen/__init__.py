"""Synthetic dataset generators (numpy only, seeded)."""

from avenir_tpu_torch.datagen.disease import DISEASE_SCHEMA_JSON, generate_disease
from avenir_tpu_torch.datagen.lead_gen import LeadGenSimulator
from avenir_tpu_torch.datagen.price_opt import PriceOptSimulator, generate_price_opt

__all__ = ["DISEASE_SCHEMA_JSON", "generate_disease", "LeadGenSimulator",
           "PriceOptSimulator", "generate_price_opt"]
