"""Process start to the first timed batch: corpus and queries, upsert,
placement on the card, kernel build or load, warm-up."""


def read(ctx):
    return ctx.setup_s
