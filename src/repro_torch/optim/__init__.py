"""Optimizers: AdamW with global-norm clipping and a cosine schedule
(``adamw``), gradient compression for the data-parallel all-reduce
(``compression``), over the parameter trees of ``tree``."""
