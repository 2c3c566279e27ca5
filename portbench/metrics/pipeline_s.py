"""Host seconds of GraphDataPipeline.build: normalization, partitioning,
reordering, halo layout, tile extraction and the upload to the card."""


def read(ctx):
    return ctx["pipeline_s"]
