"""Monte-Carlo tree search over compressed contraction orders
(experimental; counterpart of ``cotengra_tpu/pathfinders/mcts.py``, and,
as there, registered as no preset or hyper method).

State = the partially-contracted hypergraph. Actions = contracting a pair
of neighboring nodes. Selection uses UCB over visited actions; rollouts
complete the order with the greedy-compressed heuristic; the reward is the
negative compressed score of the finished order.
"""

import math

from ..hypergraph import HyperGraph
from ..scoring import parse_minimize
from ..tree_compressed import ContractionTreeCompressed
from ..utils.misc import get_rng


class _MCTSNode:
    __slots__ = ("key", "visits", "value", "children")

    def __init__(self, key):
        self.key = key
        self.visits = 0
        self.value = float("inf")  # best (lowest) score seen
        self.children = {}  # action -> _MCTSNode


def optimize_mcts_compressed(
    inputs,
    output,
    size_dict,
    chi="auto",
    minimize="peak-compressed",
    num_simulations=64,
    exploration=0.3,
    seed=None,
    use_ssa=False,
):
    """MCTS over compressed contraction orders. Returns a path."""
    from .compressed import greedy_compressed_ssa

    rng = get_rng(seed)
    objective = parse_minimize(minimize)
    if chi == "auto":
        chi = max(size_dict.values(), default=2) ** 2
    n = len(inputs)

    def score_path(ssa_path):
        tree = ContractionTreeCompressed.from_path(
            inputs, output, size_dict, ssa_path=ssa_path
        )
        trial = {"tree": tree}
        try:
            return objective(trial)
        except Exception:
            return float("inf")

    root = _MCTSNode(key=())

    best_path = None
    best_score = float("inf")

    for _sim in range(num_simulations):
        # walk down the search tree re-simulating the hypergraph
        hg = HyperGraph(inputs, output, size_dict)
        ssa_of = {i: i for i in range(n)}
        ssa = n
        prefix = []
        node = root
        visited = [root]

        while True:
            # candidate actions: neighboring pairs
            cands = []
            seen = set()
            for i in list(hg.nodes):
                for j in hg.neighbors(i):
                    key = (min(i, j), max(i, j))
                    if key not in seen:
                        seen.add(key)
                        cands.append(key)
            if not cands:
                break

            unexplored = [a for a in cands if a not in node.children]
            if unexplored:
                action = rng.choice(unexplored)
                child = node.children[action] = _MCTSNode(action)
                descend = False
            else:
                # UCB selection (minimization: lower value better)
                logN = math.log(node.visits + 1)

                def ucb(a):
                    c = node.children[a]
                    return c.value - exploration * math.sqrt(
                        logN / (c.visits + 1)
                    )

                action = min(cands, key=ucb)
                child = node.children[action]
                descend = True

            i, j = action
            k = hg.contract(i, j)
            hg.compress(chi, edges=hg.get_node(k))
            prefix.append((ssa_of.pop(i), ssa_of.pop(j)))
            ssa_of[k] = ssa
            ssa += 1
            node = child
            visited.append(child)
            if not descend:
                break

        # rollout: finish with greedy-compressed on the remaining graph
        if hg.get_num_nodes() > 1:
            sub_inputs = []
            sub_nodes = []
            for i_node, term in hg.nodes.items():
                sub_inputs.append(tuple(term))
                sub_nodes.append(i_node)
            sub_path = greedy_compressed_ssa(
                sub_inputs,
                tuple(output),
                hg.size_dict,
                chi=chi,
                temperature=0.1,
                seed=rng.randrange(2**32),
            )
            pool = [ssa_of[i_node] for i_node in sub_nodes]
            for a, b in sub_path:
                prefix.append((pool[a], pool[b]))
                pool.append(ssa)
                ssa += 1

        s = score_path(prefix)
        if s < best_score:
            best_score = s
            best_path = list(prefix)

        # backprop along the exact descent chain
        for vn in visited:
            vn.visits += 1
            vn.value = min(vn.value, s)

    if best_path is None:
        raise RuntimeError("MCTS found no complete path")
    if use_ssa:
        return best_path
    from ..tree import ssa_to_linear

    return ssa_to_linear(best_path, n)
