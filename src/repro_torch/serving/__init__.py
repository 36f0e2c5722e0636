"""Serving data plane: bucketed inference engine and dispatch target."""
