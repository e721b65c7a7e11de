"""Entry points: synthesize, test (RTF), serve."""
