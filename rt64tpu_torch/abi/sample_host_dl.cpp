/*
 * Runtime-bound sample host: binds the backend through the
 * RT64_LoadLibrary function-pointer table (the rt64.h:269-342 binding
 * path sm64rt uses) instead of link-time symbols, exercises the
 * RT64_ApplyMaterialAttributes header inline, renders one frame, and
 * writes a PPM. No -lrt64tpu_torch at link time — only -ldl.
 */

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "rt64_tpu.h"

namespace {

RT64_MATRIX4 identity() {
    RT64_MATRIX4 m;
    std::memset(&m, 0, sizeof(m));
    m.m[0][0] = m.m[1][1] = m.m[2][2] = m.m[3][3] = 1.0f;
    return m;
}

}  // namespace

int main(int argc, char **argv) {
    const char *out_path = argc > 1 ? argv[1] : "sample_host_dl.ppm";

    RT64_LIBRARY lib = RT64_LoadLibrary();
    if (lib.handle == nullptr) {
        std::fprintf(stderr, "RT64_LoadLibrary failed: %s\n", dlerror());
        return 1;
    }
    std::printf("library bound via pointer table\n");

    /* Overlay smoke test of the header inline: only flagged fields move. */
    RT64_MATERIAL base{};
    base.reflectionFactor = 0.1f;
    base.specularExponent = 5.0f;
    RT64_MATERIAL over{};
    over.reflectionFactor = 0.9f;
    over.specularExponent = 50.0f;
    over.enabledAttributes = RT64_ATTRIBUTE_REFLECTION_FACTOR;
    RT64_ApplyMaterialAttributes(&base, &over);
    if (base.reflectionFactor != 0.9f || base.specularExponent != 5.0f) {
        std::fprintf(stderr, "ApplyMaterialAttributes overlay is wrong\n");
        return 1;
    }

    RT64_DEVICE *device = lib.CreateDevice(nullptr);
    if (device == nullptr) {
        std::fprintf(stderr, "CreateDevice failed: %s\n", lib.GetLastError());
        return 1;
    }
    RT64_SCENE *scene = lib.CreateScene(device);
    RT64_VIEW *view = lib.CreateView(scene);

    /* One vertex-color triangle (combiner color = INPUT_1; layout is
     * shader-defined: pos4 + nrm3 + input1 float3). */
    struct Vtx {
        float pos[4];
        float nrm[3];
        float col[3];
    };
    Vtx verts[3] = {};
    float xs[3] = {-2.0f, 2.0f, 0.0f};
    float ys[3] = {0.0f, 0.0f, 3.0f};
    for (int i = 0; i < 3; ++i) {
        verts[i].pos[0] = xs[i];
        verts[i].pos[1] = ys[i];
        verts[i].pos[3] = 1.0f;
        verts[i].nrm[2] = 1.0f;
        verts[i].col[0] = 0.9f;
        verts[i].col[1] = 0.4f;
        verts[i].col[2] = 0.2f;
    }
    unsigned idx[3] = {0, 1, 2};
    RT64_SHADER *shader = lib.CreateShader(
        device, 1u << 9 | 1u << 21, RT64_SHADER_FILTER_POINT,
        RT64_SHADER_ADDRESSING_WRAP, RT64_SHADER_ADDRESSING_WRAP,
        RT64_SHADER_RAYTRACE_ENABLED);
    RT64_MESH *mesh = lib.CreateMesh(device, RT64_MESH_RAYTRACE_ENABLED);
    lib.SetMesh(mesh, verts, 3, sizeof(Vtx), idx, 3);

    RT64_INSTANCE *inst = lib.CreateInstance(scene);

    RT64_LIGHT light{};
    light.position = {5.0f, 8.0f, 10.0f};
    light.diffuseColor = {1.0f, 1.0f, 1.0f};
    light.attenuationRadius = 10000.0f;
    light.pointRadius = 1.0f;
    light.attenuationExponent = 1.0f;
    light.groupBits = RT64_LIGHT_GROUP_DEFAULT;
    lib.SetSceneLights(scene, &light, 1);

    RT64_SCENE_DESC sd{};
    sd.ambientBaseColor = {0.3f, 0.3f, 0.3f};
    lib.SetSceneDescription(scene, sd);

    RT64_VIEW_DESC vd{};
    vd.resolutionScale = 1.0f;
    vd.diSamples = 1;
    vd.maxLights = 2;
    vd.upscaler = RT64_UPSCALER_OFF;
    lib.SetViewDescription(view, vd);

    RT64_MATRIX4 vm = identity();
    vm.m[3][1] = -1.0f;
    vm.m[3][2] = -8.0f;
    lib.SetViewPerspective(view, vm, 45.0f * 3.14159265f / 180.0f, 0.1f,
                           1000.0f, true);

    RT64_INSTANCE_DESC id{};
    id.mesh = mesh;
    id.transform = identity();
    id.previousTransform = id.transform;
    id.shader = shader;
    std::memset(&id.material, 0, sizeof(id.material));
    id.material.diffuseTexIndex = -1;
    id.material.normalTexIndex = -1;
    id.material.specularTexIndex = -1;
    id.material.uvDetailScale = 1.0f;
    id.material.solidAlphaMultiplier = 1.0f;
    id.material.shadowAlphaMultiplier = 1.0f;
    id.material.lightGroupMaskBits = RT64_LIGHT_GROUP_MASK_ALL;
    lib.SetInstanceDescription(inst, id);

    lib.DrawDevice(device, 1, 1000.0f / 60.0f);

    int w = 0, h = 0;
    lib.GetViewFrameSize(view, &w, &h);
    std::vector<unsigned char> pixels(static_cast<size_t>(w) * h * 4);
    if (!lib.GetViewFramePixels(view, pixels.data(), pixels.size())) {
        std::fprintf(stderr, "GetViewFramePixels failed: %s\n",
                     lib.GetLastError());
        return 1;
    }

    FILE *f = std::fopen(out_path, "wb");
    std::fprintf(f, "P6\n%d %d\n255\n", w, h);
    for (int i = 0; i < w * h; ++i) {
        std::fwrite(&pixels[i * 4], 1, 3, f);
    }
    std::fclose(f);
    std::printf("wrote %s (%dx%d)\n", out_path, w, h);

    lib.DestroyInstance(inst);
    lib.DestroyMesh(mesh);
    lib.DestroyShader(shader);
    lib.DestroyView(view);
    lib.DestroyScene(scene);
    lib.DestroyDevice(device);
    RT64_UnloadLibrary(&lib);
    return 0;
}
