"""Configurations of the layer framework (the ported subset)."""

from deeplearning4j_tpu_torch.nn.conf.builder import (
    Builder, ListBuilder, MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    GlobalPoolingLayer, GravesLSTM, Layer, OutputLayer, PoolingType,
    RnnOutputLayer, SubsamplingLayer, ZeroPaddingLayer)

__all__ = ["Builder", "ListBuilder", "MultiLayerConfiguration",
           "NeuralNetConfiguration", "InputType", "Layer", "DenseLayer",
           "OutputLayer", "RnnOutputLayer", "LSTM", "GravesLSTM",
           "ActivationLayer", "PoolingType", "ConvolutionLayer",
           "SubsamplingLayer", "ZeroPaddingLayer", "GlobalPoolingLayer",
           "BatchNormalization"]
