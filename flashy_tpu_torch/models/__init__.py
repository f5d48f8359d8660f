"""models of the PyTorch port (see the matching flashy_tpu.models)."""
from .mlp import MLP  # noqa: F401
from .moe import MoEMLP, moe_aux_loss  # noqa: F401
from .pipelined import (pipelined_apply,  # noqa: F401
                        pipelined_value_and_grad, sequential_value_and_grad)
from .resnet import ResNet, resnet18, resnet34, resnet50  # noqa: F401
from .seq2seq import (Seq2SeqConfig, Seq2SeqTransformer,  # noqa: F401
                      cached_translate, greedy_translate, init_decode_cache,
                      seq2seq_shardings)
from .vit import ViT, ViTConfig, vit_small, vit_tiny  # noqa: F401
