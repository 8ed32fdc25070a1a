"""The plain reference: tokenizers, encoders and votes in plain PyTorch
in float32 with TF32 off.  It imports nothing of the program under test
and takes nothing the program made: it reads the benchmark's own weights
(an HF-named state dict) and the texts the benchmark sent."""
