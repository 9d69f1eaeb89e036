"""The layer framework: configurations (``nn.conf``), weight init
(``nn.weights``), ``nn.multilayer.MultiLayerNetwork`` and
``nn.graph.ComputationGraph``."""
