"""Entry points of the port that are not stages of the assembler."""
