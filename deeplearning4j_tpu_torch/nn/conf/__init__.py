"""Configurations of the layer framework (the ported subset)."""

from deeplearning4j_tpu_torch.nn.conf.builder import (
    Builder, ListBuilder, MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, ActivationLayer, BatchNormalization, Bidirectional, CnnLossLayer,
    ConvolutionLayer, DenseLayer, DropoutLayer, EmbeddingLayer,
    EmbeddingSequenceLayer, FlattenLayer, GlobalPoolingLayer, GravesLSTM,
    LastTimeStep, Layer, LayerNormalization, LocalResponseNormalization,
    LossLayer, OutputLayer, PoolingType, RnnLossLayer, RnnOutputLayer,
    SimpleRnn, SubsamplingLayer, ZeroPaddingLayer)

__all__ = ["Builder", "ListBuilder", "MultiLayerConfiguration",
           "NeuralNetConfiguration", "InputType", "Layer", "DenseLayer",
           "OutputLayer", "RnnOutputLayer", "LSTM", "GravesLSTM",
           "ActivationLayer", "PoolingType", "ConvolutionLayer",
           "SubsamplingLayer", "ZeroPaddingLayer", "GlobalPoolingLayer",
           "BatchNormalization", "LossLayer", "CnnLossLayer", "RnnLossLayer",
           "EmbeddingLayer", "EmbeddingSequenceLayer", "LastTimeStep",
           "SimpleRnn", "Bidirectional", "DropoutLayer", "FlattenLayer",
           "LayerNormalization", "LocalResponseNormalization"]
