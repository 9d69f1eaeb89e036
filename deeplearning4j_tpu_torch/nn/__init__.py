"""The layer framework: configurations (``nn.conf``), weight init
(``nn.weights``) and ``nn.multilayer.MultiLayerNetwork``."""
