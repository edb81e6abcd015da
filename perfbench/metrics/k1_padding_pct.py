"""The padding share of K1's input over the window: 100 x (padded bases -
bases) / padded bases, summed over the blocks the classifier handed to K1
(``build.launches`` counters ``extract_metamers.padded_bases``, rows x
width of each block, and ``extract_metamers.bases``, those rows'
lengths). A program without the counters gives nothing."""


def read(ctx):
    padded = ctx.launches.get("extract_metamers.padded_bases")
    bases = ctx.launches.get("extract_metamers.bases")
    if not padded or bases is None:
        return None
    return 100.0 * (padded - bases) / padded
