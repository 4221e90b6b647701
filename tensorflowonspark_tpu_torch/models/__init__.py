"""Models (the Llama-family decoder's training path)."""
