"""Seq2seq encoder-decoder LSTM: counterpart of
``deeplearning4j_tpu/models/seq2seq.py``.

The encoder LSTM reads the source sequence; its last step (the "thought"
vector, ``LastTimeStepVertex``) is broadcast along the decoder's time
axis (``DuplicateToTimeSeriesVertex``) and concatenated with the
teacher-forced decoder input (``MergeVertex``); a decoder LSTM and an
``RnnOutputLayer`` emit the target sequence. Both LSTMs run the
recurrence kernels on the card, forward and backward.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertex, LastTimeStepVertex, MergeVertex)


class Seq2SeqLSTM:
    """Builder of the encoder-decoder graph: inputs ``encoderInput``
    ``[N, t_in, in_features]`` and ``decoderInput`` (the shifted target)
    ``[N, t_out, out_features]``, output ``output`` (softmax, MCXENT)."""

    def __init__(self, in_features: int, out_features: int,
                 hidden: int = 128, t_in: int = 12, t_out: int = 12,
                 seed: int = 42, updater=None):
        self.in_features = in_features
        self.out_features = out_features
        self.hidden = hidden
        self.t_in = t_in
        self.t_out = t_out
        self.seed = seed
        self.updater = updater or Adam(5e-3)

    def conf(self) -> ComputationGraphConfiguration:
        b = (ComputationGraphConfiguration.graphBuilder()
             .seed(self.seed).updater(self.updater)
             .addInputs("encoderInput", "decoderInput")
             .setInputTypes(
                 InputType.recurrent(self.in_features, self.t_in),
                 InputType.recurrent(self.out_features, self.t_out)))
        b.addLayer("encoder", LSTM(n_out=self.hidden, activation="tanh"),
                   "encoderInput")
        b.addVertex("thought", LastTimeStepVertex(), "encoder")
        b.addVertex("dup", DuplicateToTimeSeriesVertex(), "thought",
                    "decoderInput")
        b.addVertex("decoderIn", MergeVertex(), "decoderInput", "dup")
        b.addLayer("decoder", LSTM(n_out=self.hidden, activation="tanh"),
                   "decoderIn")
        b.addLayer("output", RnnOutputLayer(n_out=self.out_features,
                                            activation="softmax",
                                            loss="mcxent"), "decoder")
        return b.setOutputs("output").build()

    def init(self, device=None) -> ComputationGraph:
        """The graph on ``device`` (the CUDA card unless ``"cpu"`` is
        given), initialised from ``seed``."""
        return ComputationGraph(self.conf(), device=device).init()


__all__ = ["Seq2SeqLSTM"]
