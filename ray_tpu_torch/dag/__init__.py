"""Lazy DAG API + compiled execution (the port's copy of ray_tpu/dag/).

(reference: python/ray/dag/ — DAGNode/InputNode/MultiOutputNode
(dag_node.py, input_node.py, output_node.py), .bind() builders on tasks and
actor methods, experimental_compile → CompiledDAG
(compiled_dag_node.py:805). The compiled form runs on the channel execution
plane when eligible: per-actor exec loops over mutable-shm channels,
channel_execution.py.)
"""

from ray_tpu_torch.dag.channel_execution import ChannelDAGFuture, ChannelExecutor
from ray_tpu_torch.dag.dag_node import (
    AwaitableDAGFuture,
    ClassMethodNode,
    CompiledDAG,
    DAGFuture,
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "AwaitableDAGFuture",
    "ChannelDAGFuture",
    "ChannelExecutor",
    "ClassMethodNode",
    "CompiledDAG",
    "DAGFuture",
    "DAGNode",
    "FunctionNode",
    "InputNode",
    "MultiOutputNode",
]
