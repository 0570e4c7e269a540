"""The benchmark's plain reference: FBANet, translation ECC, the loss,
the metrics and AdamW in float32 PyTorch. It imports nothing of the
program under test and takes nothing the program made; the harness hands
it the same weights and inputs it hands the program."""
