"""Model zoo: the shared DSL builders plus the port's serving runtime."""

from exprgrad_tpu.models.autoencoder import conv_autoencoder
from exprgrad_tpu.models.diffusion import tiny_diffusion
from exprgrad_tpu.models.mixer import tiny_mixer
from exprgrad_tpu.models.mnist import fashion_mnist_cnn
from exprgrad_tpu.models.gan import mnist_gan
from exprgrad_tpu.models.mobile import mobile_cnn
from exprgrad_tpu.models.rnn import tiny_recurrent_lm
from exprgrad_tpu.models.seq2seq import tiny_seq2seq
from exprgrad_tpu.models.transformer import flash_transformer, tiny_transformer
from exprgrad_tpu.models.vae import tiny_vae
from exprgrad_tpu.models.vit import patchify, tiny_vit
from exprgrad_tpu.models.xor import xor_from_scratch, xor_mlp

from .serve import FlashLMServer

__all__ = [
    "FlashLMServer", "conv_autoencoder", "fashion_mnist_cnn",
    "flash_transformer", "mnist_gan", "mobile_cnn", "patchify",
    "tiny_diffusion", "tiny_mixer", "tiny_recurrent_lm", "tiny_seq2seq",
    "tiny_transformer", "tiny_vae", "tiny_vit", "xor_from_scratch",
    "xor_mlp",
]
