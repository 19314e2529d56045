"""Model zoo: the DSL builders (copies of the JAX package's) plus the
port's serving runtime."""

from .autoencoder import conv_autoencoder
from .diffusion import tiny_diffusion
from .mixer import tiny_mixer
from .mnist import fashion_mnist_cnn
from .gan import mnist_gan
from .mobile import mobile_cnn
from .rnn import tiny_recurrent_lm
from .seq2seq import tiny_seq2seq
from .transformer import flash_transformer, tiny_transformer
from .vae import tiny_vae
from .vit import patchify, tiny_vit
from .xor import xor_from_scratch, xor_mlp

from .serve import FlashLMServer

__all__ = [
    "FlashLMServer", "conv_autoencoder", "fashion_mnist_cnn",
    "flash_transformer", "mnist_gan", "mobile_cnn", "patchify",
    "tiny_diffusion", "tiny_mixer", "tiny_recurrent_lm", "tiny_seq2seq",
    "tiny_transformer", "tiny_vae", "tiny_vit", "xor_from_scratch",
    "xor_mlp",
]
