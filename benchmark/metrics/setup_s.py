"""Process start to the first timed step: imports, kernel build or load,
inputs and weights made on the card, the program's set-up and its checked
(warm-up) steps or batches."""


def read(rec):
    return rec.setup_s
