"""Serving: the LM decode executor and the request records it serves.

The rest of the reference's serving subsystem (load generators, the
continuous-batching scheduler, metrics, SLOs, sessions, routing and
elasticity) waits for the serving slice (ROADMAP.md Queue 1 item 11).
"""
from .lm import LMDecodeExecutor, decode_traits
from .requests import LM_DECODE, Request, RequestResult
from .scheduler import BatchExecution, BatchPolicy

__all__ = ["BatchExecution", "BatchPolicy", "LMDecodeExecutor", "LM_DECODE",
           "Request", "RequestResult", "decode_traits"]
