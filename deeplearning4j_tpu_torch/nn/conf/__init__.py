"""Configurations of the layer framework: the builders and
``InputType``; every layer of ``layers.py`` (dense and output heads, the
recurrent family, embeddings, the image layers, the normalizations,
dropout, flatten, and the attention layers ``SelfAttentionLayer``,
``LearnedSelfAttentionLayer`` and ``RecurrentAttentionLayer``) and of
``layers_extra.py`` (``GRU``, ``GravesBidirectionalLSTM``, the 1D, 2D and
3D convolution, pooling, cropping and padding layers, the locally
connected, misc, capsule and structural layers); ``objdetect.py`` whole
(``Yolo2OutputLayer``, ``DetectedObject``, ``YoloUtils``); the
pretrainable ``VariationalAutoencoder`` and ``AutoEncoder``
(``variational.py``) and ``OCNNOutputLayer`` (``ocnn.py``); and the
per-layer regularisation configs: the ``IDropout`` family
(``dropout.py``), weight noise (``weightnoise.py``) and constraints
(``constraint.py``). The frozen wrappers live in
``nn.transferlearning``."""

from deeplearning4j_tpu_torch.nn.conf.builder import (
    Builder, ListBuilder, MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.constraint import (
    LayerConstraint, MaxNormConstraint, MinMaxNormConstraint,
    NonNegativeConstraint, UnitNormConstraint)
from deeplearning4j_tpu_torch.nn.conf.dropout import (
    AlphaDropout, Dropout, GaussianDropout, GaussianNoise, IDropout,
    SpatialDropout)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, ActivationLayer, BatchNormalization, Bidirectional, CnnLossLayer,
    ConvolutionLayer, DenseLayer, DropoutLayer, EmbeddingLayer,
    EmbeddingSequenceLayer, FlattenLayer, GlobalPoolingLayer, GravesLSTM,
    LastTimeStep, Layer, LayerNormalization, LocalResponseNormalization,
    LossLayer, OutputLayer, PoolingType, RnnLossLayer, RnnOutputLayer,
    SeparableConvolution2D, SimpleRnn, SubsamplingLayer, Upsampling2D,
    ZeroPaddingLayer, SelfAttentionLayer, LearnedSelfAttentionLayer,
    RecurrentAttentionLayer)
from deeplearning4j_tpu_torch.nn.conf.layers_extra import (
    GRU, CapsuleLayer, CapsuleStrengthLayer, CenterLossOutputLayer,
    Convolution1D, Convolution3D, Cropping1D, Cropping2D, Cropping3D,
    Deconvolution2D, Deconvolution3D, DepthwiseConvolution2D,
    ElementWiseMultiplicationLayer, GravesBidirectionalLSTM, LambdaLayer,
    LocallyConnected1D, LocallyConnected2D, MaskLayer, MaskZeroLayer,
    PermuteLayer, PReLULayer, PrimaryCapsules, RepeatVector, ReshapeLayer,
    SpaceToBatchLayer, SpaceToDepthLayer, Subsampling1DLayer,
    Subsampling3DLayer, Upsampling1D, Upsampling3D, ZeroPadding1DLayer,
    ZeroPadding3DLayer)
from deeplearning4j_tpu_torch.nn.conf.objdetect import (
    DetectedObject, Yolo2OutputLayer, YoloUtils)
from deeplearning4j_tpu_torch.nn.conf.ocnn import OCNNOutputLayer
from deeplearning4j_tpu_torch.nn.conf.variational import (
    AutoEncoder, VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.conf.weightnoise import (
    DropConnect, IWeightNoise, WeightNoise)

__all__ = ["Builder", "ListBuilder", "MultiLayerConfiguration",
           "NeuralNetConfiguration", "InputType", "Layer", "DenseLayer",
           "OutputLayer", "RnnOutputLayer", "LSTM", "GravesLSTM",
           "ActivationLayer", "PoolingType", "ConvolutionLayer",
           "SeparableConvolution2D", "SubsamplingLayer", "Upsampling2D",
           "ZeroPaddingLayer", "GlobalPoolingLayer",
           "BatchNormalization", "LossLayer", "CnnLossLayer", "RnnLossLayer",
           "EmbeddingLayer", "EmbeddingSequenceLayer", "LastTimeStep",
           "SimpleRnn", "Bidirectional", "DropoutLayer", "FlattenLayer",
           "LayerNormalization", "LocalResponseNormalization",
           "SelfAttentionLayer", "LearnedSelfAttentionLayer",
           "RecurrentAttentionLayer",
           "GRU", "CapsuleLayer", "CapsuleStrengthLayer",
           "CenterLossOutputLayer", "Convolution1D", "Convolution3D",
           "Cropping1D", "Cropping2D", "Cropping3D", "Deconvolution2D",
           "Deconvolution3D", "ElementWiseMultiplicationLayer",
           "GravesBidirectionalLSTM", "LambdaLayer", "LocallyConnected1D",
           "LocallyConnected2D", "MaskLayer", "MaskZeroLayer",
           "PermuteLayer", "PReLULayer", "PrimaryCapsules", "RepeatVector",
           "ReshapeLayer", "SpaceToBatchLayer", "Subsampling1DLayer",
           "Subsampling3DLayer", "Upsampling1D", "Upsampling3D",
           "ZeroPadding1DLayer", "ZeroPadding3DLayer",
           "DepthwiseConvolution2D", "SpaceToDepthLayer",
           "Yolo2OutputLayer", "DetectedObject", "YoloUtils",
           "AlphaDropout", "Dropout", "GaussianDropout", "GaussianNoise",
           "IDropout", "SpatialDropout",
           "DropConnect", "IWeightNoise", "WeightNoise",
           "LayerConstraint", "MaxNormConstraint", "MinMaxNormConstraint",
           "NonNegativeConstraint", "UnitNormConstraint",
           "AutoEncoder", "VariationalAutoencoder", "OCNNOutputLayer"]
