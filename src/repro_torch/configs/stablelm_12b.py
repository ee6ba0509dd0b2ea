"""StableLM-2-12B: dense GQA kv=8 [hf:stabilityai/stablelm-2-12b]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352, rope_theta=1e4,
)
