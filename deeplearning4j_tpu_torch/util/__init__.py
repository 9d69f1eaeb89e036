"""Utilities: ``util.model_serializer`` (the ModelSerializer zips both
packages share: write, restore, the normalizer beside the model)."""
