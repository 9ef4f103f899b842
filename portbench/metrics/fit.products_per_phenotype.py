"""GRM products per phenotype fitted over the window: the operator's own
product counter (``Packed2GRM.matvecs``) over the lanes fitted."""


def read(ctx):
    c = ctx["counters"]
    if "matvecs" not in c or not c.get("phenotypes"):
        return None
    return c["matvecs"] / c["phenotypes"]
