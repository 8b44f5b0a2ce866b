"""Model code of the port: layers, attention, transformer, LM steps."""
