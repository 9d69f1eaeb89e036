"""Utilities: ``util.model_serializer`` (the read side of the JAX
package's ModelSerializer zips)."""
