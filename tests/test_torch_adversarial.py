# The port's AdversarialLoss against the JAX package's on the same MLP
# discriminator weights (carried across by mlp_from_jax), in f32 on the
# CPU: the five cases of tests/test_adversarial.py. D losses and D
# parameters after 3 Adam steps within 1e-5 relative (optax takes its
# bias corrections in f32, torch in f64); the generator loss within 1e-6;
# D shielded from the generator's backward; the state round trip through
# the port's checkpoint.
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

LR = 0.05
FEATURES = [8, 1]
STEPS = 3


def _pair():
    """(JAX AdversarialLoss, port AdversarialLoss, port D) on one MLP."""
    from flashy_tpu.adversarial import AdversarialLoss as JaxAdversarial
    from flashy_tpu.models import MLP as JaxMLP
    from flashy_tpu_torch.adversarial import AdversarialLoss
    from flashy_tpu_torch.models import MLP
    from flashy_tpu_torch.models.convert import mlp_from_jax
    jax_disc = JaxMLP(FEATURES)
    params = jax_disc.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    jax_adv = JaxAdversarial(jax_disc.apply, params, optax.adam(LR))
    disc = MLP(FEATURES, in_features=3, device="cpu")
    disc.load_state_dict(mlp_from_jax(jax.tree.map(np.asarray, params),
                                      disc))
    return jax_adv, AdversarialLoss(disc, torch.optim.Adam(
        disc.parameters(), lr=LR)), disc


def _batches(seed=0, n=8):
    rng = np.random.default_rng(seed)
    fake = (rng.normal(size=(n, 3)) + 1.5).astype(np.float32)
    real = (rng.normal(size=(n, 3)) - 1.5).astype(np.float32)
    return fake, real


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_params_close(jax_adv, disc, rtol):
    from flashy_tpu_torch.models.convert import mlp_from_jax
    want = mlp_from_jax(jax.tree.map(np.asarray, jax_adv.params), disc)
    for name, value in disc.state_dict().items():
        assert _rel(value.numpy(), want[name].numpy()) <= rtol, name


def test_train_adv_updates_discriminator():
    jax_adv, adv, disc = _pair()
    fake, real = _batches()
    for _ in range(STEPS):
        want = float(jax_adv.train_adv(jnp.asarray(fake), jnp.asarray(real)))
        got = float(adv.train_adv(torch.from_numpy(fake),
                                  torch.from_numpy(real)))
        assert abs(got - want) <= 1e-5 * abs(want)
    _assert_params_close(jax_adv, disc, 1e-5)
    first = got
    for _ in range(50):
        last = float(adv.train_adv(torch.from_numpy(fake),
                                   torch.from_numpy(real)))
    assert last < first          # D learns to separate them
    with torch.no_grad():        # and calls the fakes fake
        assert float(disc(torch.from_numpy(fake)).mean()) > \
            float(disc(torch.from_numpy(real)).mean())


def test_generator_loss_direction():
    jax_adv, adv, _ = _pair()
    fake, real = _batches(1)
    # the same weights: the same generator loss
    want = float(jax_adv(jnp.asarray(fake)))
    got = float(adv(torch.from_numpy(fake)))
    assert abs(got - want) <= 1e-6
    for _ in range(100):
        adv.train_adv(torch.from_numpy(fake), torch.from_numpy(real))
    # a fake that looks real (negative) fools D better: a lower loss
    fooled = float(adv(-torch.ones(4, 3)))
    obvious = float(adv(torch.ones(4, 3)))
    assert fooled < obvious


def test_gen_loss_shields_discriminator_params():
    jax_adv, adv, disc = _pair()
    fake, _ = _batches(2)
    source = torch.tensor(1.0, requires_grad=True)
    loss = adv.gen_loss(source * torch.from_numpy(fake))
    loss.backward()
    # the gradient reaches the generator side ...
    want = jax.grad(lambda s: jax_adv.gen_loss(
        jax_adv.params, s * jnp.asarray(fake)))(1.0)
    assert abs(float(source.grad) - float(want)) <= 1e-6
    assert float(source.grad) != 0.0
    # ... and not the discriminator
    assert all(p.grad is None for p in disc.parameters())


def test_train_adv_does_not_touch_generator_inputs():
    _, adv, disc = _pair()
    generator = torch.nn.Linear(3, 3)
    before = [p.detach().clone() for p in generator.parameters()]
    noise, real = _batches(3)
    fake = generator(torch.from_numpy(noise))
    d_before = [p.detach().clone() for p in disc.parameters()]
    adv.train_adv(fake, torch.from_numpy(real))
    assert all(p.grad is None for p in generator.parameters())
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 generator.parameters()))
    assert not all(torch.equal(a, b) for a, b in zip(d_before,
                                                     disc.parameters()))


def test_state_dict_embeds_optimizer(tmp_path):
    from flashy_tpu_torch.adversarial import AdversarialLoss
    from flashy_tpu_torch.checkpoint import load_state, save_state
    from flashy_tpu_torch.models import MLP
    jax_adv, adv, disc = _pair()
    fake, real = _batches(4)
    for _ in range(2):
        jax_adv.train_adv(jnp.asarray(fake), jnp.asarray(real))
        adv.train_adv(torch.from_numpy(fake), torch.from_numpy(real))
    state = adv.state_dict()
    assert set(state) == {"params", "optimizer"}
    save_state(state, tmp_path / "adv.th")
    fresh_disc = MLP(FEATURES, in_features=3, device="cpu", seed=1)
    fresh = AdversarialLoss(fresh_disc, torch.optim.Adam(
        fresh_disc.parameters(), lr=LR))
    fresh.load_state_dict(load_state(tmp_path / "adv.th"))
    for name, value in disc.state_dict().items():
        assert torch.equal(fresh_disc.state_dict()[name], value), name
    # the next step: the restored copy bit-identical to the twin that
    # never saved, both within 1e-5 of the JAX package's
    want = float(jax_adv.train_adv(jnp.asarray(fake), jnp.asarray(real)))
    got = adv.train_adv(torch.from_numpy(fake), torch.from_numpy(real))
    again = fresh.train_adv(torch.from_numpy(fake), torch.from_numpy(real))
    assert torch.equal(got, again)
    assert abs(float(got) - want) <= 1e-5 * abs(want)
    for a, b in zip(disc.parameters(), fresh_disc.parameters()):
        assert torch.equal(a, b)
    _assert_params_close(jax_adv, disc, 1e-5)


def test_bce_with_logits_is_optaxs():
    from flashy_tpu.adversarial import bce_with_logits as jax_bce
    from flashy_tpu_torch.adversarial import bce_with_logits
    logits = np.linspace(-30, 30, 41, dtype=np.float32)
    for target in (0.0, 1.0):
        targets = np.full_like(logits, target)
        want = float(jax_bce(jnp.asarray(logits), jnp.asarray(targets)))
        got = float(bce_with_logits(torch.from_numpy(logits),
                                    torch.from_numpy(targets)))
        assert got == pytest.approx(want, rel=1e-6)
