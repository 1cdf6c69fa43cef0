"""The LM substrate's step builders and decoding loops (serving half)."""
