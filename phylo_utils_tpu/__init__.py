"""phylo_utils_tpu — a phylogenetic likelihood engine on JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference library ``kgori/phylo_utils`` (see SURVEY.md; the reference mount
was empty this session, so capability citations are given as
``phylo_utils/<module> [confidence]`` per SURVEY.md §0):

* substitution models: JC69/K80/F81/F84/HKY85/TN93/GTR (DNA),
  LG/WAG (protein), UNREST (non-reversible)      [models.py, HIGH]
* transition matrices via reversible eigendecomposition, with
  dP/dt and d2P/dt2                               [markov.py, MED]
* Felsenstein pruning over post-order schedules with per-node
  rescaling                                       [likcalc.pyx, HIGH]
* discrete-gamma + invariant-sites rate mixtures  [likelihood.py, HIGH]
* branch-length and model-parameter optimization  [optimisation.py, MED]
* sequence simulation                             [simulation.py, MED]
* alignment ingestion incl. IUPAC ambiguity codes and site-pattern
  compression                                     [__init__/data.py, HIGH]

The design is built for an accelerator, not a port: pure functions over
PyTrees with static shapes, tree topologies compiled to padded level
schedules, rate categories vmapped, sites sharded data-parallel over a
``jax.sharding.Mesh``, and the pruning hot loop one batched XLA einsum per
level of the tree.
"""

__version__ = "0.1.0"

from phylo_utils_tpu.ancestral import (  # noqa: F401
    ancestral_posteriors,
    site_rate_posteriors,
)
from phylo_utils_tpu.alphabets import (  # noqa: F401
    DNA,
    PROTEIN,
    Alphabet,
    seq_to_partials,
    encode_alignment,
)

# Public API re-exports: a reference user should find everything at the top
# level. Heavy imports (jax tracing) happen lazily inside the modules.
from phylo_utils_tpu import models  # noqa: F401
from phylo_utils_tpu.io import (  # noqa: F401
    CompressedAlignment,
    compress_patterns,
    load_compressed,
    parse_newick,
    read_alignment,
    read_fasta,
    read_phylip,
    write_newick,
)
from phylo_utils_tpu.batched import (  # noqa: F401
    TopologySetEngine,
    nni_hill_climb,
    optimize_branch_lengths,
)
from phylo_utils_tpu.branch_models import (  # noqa: F401
    BranchModelEngine,
    BranchSiteAEngine,
    branch_site_test,
    free_ratio_classes,
    mark_branches,
    mark_clade,
)
from phylo_utils_tpu.clock import (  # noqa: F401
    ClockEngine,
    clock_test,
    node_height_errors,
)
from phylo_utils_tpu.likelihood import GammaMixture, LikelihoodEngine  # noqa: F401
from phylo_utils_tpu.markov import TransitionMatrix  # noqa: F401
from phylo_utils_tpu.partition import (  # noqa: F401
    Partition,
    PartitionedEngine,
    StackedPartitionedEngine,
)
from phylo_utils_tpu.server import EngineServer  # noqa: F401
from phylo_utils_tpu.topology_tests import kh_test, sh_test  # noqa: F401
from phylo_utils_tpu.optimize import (  # noqa: F401
    brent_minimize,
    fit,
    golden_section,
    newton_branch_length,
)
from phylo_utils_tpu.supports import (  # noqa: F401
    alrt_supports,
    bootstrap_tree_support,
)
from phylo_utils_tpu.simulate import (  # noqa: F401
    SequenceSimulator,
    simulate_alignment,
    simulate_branch_alignment,
    simulate_mixture_alignment,
)
from phylo_utils_tpu.mixtures import (  # noqa: F401
    M1aEngine,
    M2aEngine,
    M7Engine,
    M8Engine,
    ModelMixtureEngine,
    beb_site_posteriors,
    beb_site_posteriors_m8,
    m1a_m2a_test,
    omega_posteriors,
    positive_selection_test,
)
from phylo_utils_tpu.model_selection import compare_models  # noqa: F401
from phylo_utils_tpu.nj import neighbor_joining  # noqa: F401
from phylo_utils_tpu.trees import (  # noqa: F401
    Tree,
    compile_schedule,
    midpoint_root,
    nni_neighbors,
    random_tree,
    reroot,
    robinson_foulds,
    spr_neighbors,
)
