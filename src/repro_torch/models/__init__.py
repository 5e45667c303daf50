"""Model layers, attention, blocks and the LM."""
