"""Dense decoder-only model: params, layers, attention, LM, registry."""
