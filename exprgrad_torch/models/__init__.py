"""Model zoo: the DSL builders (copies of the JAX package's) plus the
port's serving runtime."""

from .autoencoder import conv_autoencoder
from .diffusion import (ddpm_sample, ddpm_schedule, diffusion_train_batch,
                        tiny_diffusion)
from .mixer import tiny_mixer
from .mnist import fashion_mnist_cnn
from .gan import mnist_gan
from .mobile import mobile_cnn
from .rnn import tiny_recurrent_lm
from .seq2seq import greedy_decode, tiny_seq2seq
from .transformer import flash_transformer, tiny_transformer
from .vae import tiny_vae, vae_sample, vae_train_batch
from .vit import patchify, tiny_vit
from .xor import xor_from_scratch, xor_mlp

from .serve import FlashLMServer
from .batcher import ContinuousBatcher, Seq2SeqBatcher
from .rnn_serve import RecurrentServer
from .seq2seq_serve import Seq2SeqServer

__all__ = [
    "ContinuousBatcher", "FlashLMServer", "conv_autoencoder", "ddpm_sample",
    "ddpm_schedule", "diffusion_train_batch", "fashion_mnist_cnn",
    "flash_transformer", "greedy_decode", "mnist_gan", "mobile_cnn",
    "patchify", "RecurrentServer", "Seq2SeqBatcher", "Seq2SeqServer",
    "tiny_diffusion", "tiny_mixer", "tiny_recurrent_lm",
    "tiny_seq2seq", "tiny_transformer", "tiny_vae", "tiny_vit",
    "vae_sample", "vae_train_batch", "xor_from_scratch", "xor_mlp",
]
