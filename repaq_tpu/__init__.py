"""repaq_tpu: accelerator-native lossless FASTQ codec, wire-compatible with
OpenGene/repaq's .rfq container (algorithm version 2)."""

from .constants import ALGORITHM_VER, VERSION_NUM

__version__ = "0.1.0"
