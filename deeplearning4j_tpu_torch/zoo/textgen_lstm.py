"""Character-level text-generation LSTM: counterpart of
``deeplearning4j_tpu/zoo/textgen_lstm.py`` (DL4J's TextGenerationLSTM:
2 x LSTM(256) and a per-timestep softmax head, trained with truncated
BPTT; pairs with ``MultiLayerNetwork.rnnTimeStep`` for sampling)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.nn.conf import (
    LSTM, InputType, NeuralNetConfiguration, RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class TextGenerationLSTM(ZooModel):
    def __init__(self, vocab_size: int = 77, hidden: int = 256,
                 seed: int = 42, updater=None, tbptt_length: int = 50,
                 precision=None):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.seed = seed
        self.updater = updater or Adam(1e-3)
        self.tbptt_length = tbptt_length
        #: only None is ported (a mixed policy raises at build time)
        self.precision = precision

    def conf(self):
        lb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(self.updater).precision(self.precision).list()
              .layer(LSTM(n_out=self.hidden))
              .layer(LSTM(n_out=self.hidden))
              .layer(RnnOutputLayer(n_out=self.vocab_size,
                                    activation="softmax", loss="mcxent"))
              .setInputType(InputType.recurrent(self.vocab_size)))
        if self.tbptt_length:
            lb = lb.backpropType("TruncatedBPTT").tBPTTLength(
                self.tbptt_length)
        return lb.build()

    def init(self, device=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()
