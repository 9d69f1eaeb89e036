"""See the package docstring."""

from deeplearning4j_tpu_torch.models.seq2seq import Seq2SeqLSTM

__all__ = ["Seq2SeqLSTM"]
