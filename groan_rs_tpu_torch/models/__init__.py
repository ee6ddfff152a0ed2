"""Composed analyses: the per-frame analysis pass, the conformational
analyses of `structure.py`, the time-correlation and transport analyses
of `dynamics.py`, the membrane and interfacial-water analyses of
`membrane.py`, the geometric and surface analyses of `geometry.py` and
the per-frame converters of `convert.py`."""

from .convert import (
    CenterConverter,
    FitConverter,
    FrameAnalyze,
    FrameConvert,
    MakeWholeConverter,
    TranslateConverter,
    UnwrapConverter,
    WrapConverter,
    analyze_iter,
    convert_iter,
)
from .dynamics import (
    current,
    diffusion,
    dipole_corr,
    dos,
    filter_traj,
    hbond_acf,
    hbond_lifetime,
    msd,
    msd_mol,
    rotacf,
    tcaf,
    vacf,
    vanhove,
)
from .geometry import (
    bundle,
    dyecoupl,
    freevolume,
    gangle,
    helixorient,
    pairdist,
    pi_mindist,
    polystat,
    saltbr,
    sasa,
    sdf,
    select_dynamic,
    trjorder,
    write_cube,
)
from .membrane import (
    densmap,
    densorder,
    h2order,
    hydorder,
    leaflets,
    order_parameters,
    potential_profile,
    sorient,
    spol,
)
from .pipeline import PipelineRunner, TrajectoryAnalysis, run_many
from .structure import (
    chi,
    cluster,
    clustsize,
    cosine_content,
    dccm,
    dssp,
    entropy,
    mdmat,
    mode_traj,
    morph,
    pca,
    ramachandran,
    rmsd_matrix,
    rmsdist,
    rmsf,
    rotmat,
    subspace_overlap,
)

__all__ = ["PipelineRunner", "TrajectoryAnalysis", "run_many",
           "CenterConverter", "FitConverter", "FrameAnalyze", "FrameConvert",
           "MakeWholeConverter", "TranslateConverter", "UnwrapConverter",
           "WrapConverter", "analyze_iter", "convert_iter",
           "chi", "cluster", "clustsize", "cosine_content", "dccm", "dssp",
           "entropy", "mdmat", "mode_traj", "morph", "pca", "ramachandran",
           "rmsd_matrix", "rmsdist", "rmsf", "rotmat", "subspace_overlap",
           "current", "diffusion", "dipole_corr", "dos", "filter_traj",
           "hbond_acf", "hbond_lifetime", "msd", "msd_mol", "rotacf", "tcaf",
           "vacf", "vanhove",
           "densmap", "densorder", "h2order", "hydorder", "leaflets",
           "order_parameters", "potential_profile", "sorient", "spol",
           "bundle", "dyecoupl", "freevolume", "gangle", "helixorient",
           "pairdist", "pi_mindist", "polystat", "saltbr", "sasa", "sdf",
           "select_dynamic", "trjorder", "write_cube"]
